"""A numpy reader and writer of the HDF5 subset that Keras weight files use.

The port's stand-in for ``h5py``, which the card's machine does not have.
``File(path)`` opens a file for reading with a small h5py-like surface:
``attrs`` (a read-only mapping), ``group["a/b/c"]``, ``in``, iteration in
name order, ``visititems``, and :class:`Dataset` objects that
``np.asarray`` reads. Values come back as h5py returns them: datasets in
their stored dtype and byte order, variable-length strings as ``bytes``
in datasets and ``str`` in attributes, scalar attributes as scalars, an
attribute with a null dataspace as :class:`Empty`.

It reads what h5py writes by default and what Keras-2 weight files hold:

- superblock versions 0 and 1 (a user block before it included);
- version-1 object headers with continuation messages;
- symbol-table groups: version-1 B-trees of type 0 (internal and leaf
  nodes), local heaps and symbol-table nodes;
- datatypes: fixed-point and IEEE floating-point of either byte order,
  fixed-length strings, and variable-length strings through the global
  heap;
- dataspace versions 1 and 2 (null, scalar, simple);
- data-layout messages versions 1 to 4, contiguous and compact;
- attribute messages versions 1 to 3.

Anything else raises ``NotImplementedError`` naming the feature: chunked
or filtered data, version-2 object headers, link messages (new-style
groups), dense attribute storage, shared messages, soft links, other
datatype classes, superblock versions 2 and 3.

``File(path, "w")`` writes the same subset: groups, contiguous datasets of
numeric or fixed-length string arrays, and attributes of those types,
with superblock 0, version-1 object headers and symbol-table groups. A
group's entries fill as many symbol-table nodes as they need, under one
B-tree node whose size the superblock's internal-node K sets.
"""

from __future__ import annotations

import math
import os
import struct
import typing

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# Object-header message types.
_NIL = 0x0000
_DATASPACE = 0x0001
_LINK_INFO = 0x0002
_DATATYPE = 0x0003
_LINK = 0x0006
_EXTERNAL = 0x0007
_LAYOUT = 0x0008
_GROUP_INFO = 0x000A
_FILTERS = 0x000B
_ATTRIBUTE = 0x000C
_CONTINUATION = 0x0010
_SYMBOL_TABLE = 0x0011
_ATTRIBUTE_INFO = 0x0015
# A group member that is a soft link (symbol-table entry cache type 2).
_SOFT_LINK = -1

# IEEE layouts by size: (sign bit, exponent location, exponent size,
# mantissa location, mantissa size, exponent bias).
_IEEE = {
    2: (15, 10, 5, 0, 10, 15),
    4: (31, 23, 8, 0, 23, 127),
    8: (63, 52, 11, 0, 52, 1023),
}


class Empty:
    """The value of an attribute with a null dataspace (h5py's ``Empty``)."""

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)

    def __eq__(self, other):
        return isinstance(other, Empty) and other.dtype == self.dtype

    def __repr__(self):
        return f"Empty(dtype={self.dtype!r})"


def _align8(n: int) -> int:
    return (n + 7) & ~7


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


class _Type(typing.NamedTuple):
    """A decoded datatype: ``dtype`` of one element in memory, ``size`` of
    one element in the file, ``vlen`` for variable-length strings."""

    dtype: np.dtype
    size: int
    vlen: bool = False


class _Reader:
    """The bytes of one file, its superblock and the parsers of its
    structures."""

    def __init__(self, data: bytes):
        self.data = data
        base = 0
        while data[base : base + 8] != SIGNATURE:
            base = 512 if base == 0 else base * 2
            if base + 8 > len(data):
                raise ValueError("not an HDF5 file (no superblock signature)")
        version = data[base + 8]
        if version > 1:
            raise NotImplementedError(f"HDF5 superblock version {version}")
        self.sizeof_addr = data[base + 13]
        self.sizeof_size = data[base + 14]
        # Addresses count from the superblock, as libhdf5 takes them where
        # a user block precedes it.
        self.base = base
        # Four addresses (base, free space, end of file, one more), then
        # the root group's symbol-table entry.
        root_entry = base + 24 + (4 if version == 1 else 0) + 4 * self.sizeof_addr
        self.root = self.address(root_entry + self.sizeof_addr)
        self._headers: dict = {}
        self._heaps: dict = {}

    def uint(self, pos: int, size: int) -> int:
        return int.from_bytes(self.data[pos : pos + size], "little")

    def address(self, pos: int) -> typing.Optional[int]:
        """An address field; ``None`` where it is undefined (all ones)."""
        value = self.uint(pos, self.sizeof_addr)
        if value == (1 << (8 * self.sizeof_addr)) - 1:
            return None
        return value + self.base

    def signature(self, pos: int, expected: bytes, what: str):
        if self.data[pos : pos + 4] != expected:
            raise ValueError(f"corrupt HDF5 file: no {what} at {pos}")

    def messages(self, addr: int) -> typing.List[typing.Tuple[int, int, int]]:
        """The ``(type, start, size)`` of each message of the object header
        at ``addr``, continuation blocks followed."""
        if addr in self._headers:
            return self._headers[addr]
        data = self.data
        if data[addr : addr + 4] == b"OHDR":
            raise NotImplementedError("HDF5 version-2 object headers")
        if data[addr] != 1:
            raise ValueError(f"corrupt HDF5 file: object header version {data[addr]} at {addr}")
        chunks = [(addr + 16, self.uint(addr + 8, 4))]
        found = []
        for start, length in chunks:
            pos, end = start, start + length
            while pos + 8 <= end:
                mtype = self.uint(pos, 2)
                size = self.uint(pos + 2, 2)
                flags = data[pos + 4]
                body = pos + 8
                if flags & 0x02:
                    raise NotImplementedError("HDF5 shared object-header messages")
                if mtype == _CONTINUATION:
                    chunks.append((self.address(body),
                                   self.uint(body + self.sizeof_addr, self.sizeof_size)))
                elif mtype != _NIL:
                    found.append((mtype, body, size))
                pos = body + size
        self._headers[addr] = found
        return found

    # -- datatypes, dataspaces, raw data ------------------------------------

    def datatype(self, pos: int) -> _Type:
        data = self.data
        cls = data[pos] & 0x0F
        bits = self.uint(pos + 1, 3)
        size = self.uint(pos + 4, 4)
        props = pos + 8
        if cls in (0, 1):
            order = ">" if bits & 0x01 else "<"
            offset, precision = self.uint(props, 2), self.uint(props + 2, 2)
            if offset != 0 or precision != 8 * size:
                raise NotImplementedError(
                    f"HDF5 numbers with bit offset {offset} and precision {precision}")
        if cls == 0:
            if size not in (1, 2, 4, 8):
                raise NotImplementedError(f"HDF5 {size}-byte integers")
            kind = "i" if bits & 0x08 else "u"
            return _Type(np.dtype(f"{order}{kind}{size}"), size)
        if cls == 1:
            layout = ((bits >> 8) & 0xFF, data[props + 4], data[props + 5], data[props + 6],
                      data[props + 7], self.uint(props + 8, 4))
            if bits & 0x40 or _IEEE.get(size) != layout:
                raise NotImplementedError(f"HDF5 non-IEEE {size}-byte floating point")
            return _Type(np.dtype(f"{order}f{size}"), size)
        if cls == 3:
            return _Type(np.dtype(f"S{size}"), size)
        if cls == 9:
            if bits & 0x0F != 1:
                raise NotImplementedError("HDF5 variable-length sequences")
            # Length (4 bytes), then the global heap ID: collection address
            # and object index (4 bytes).
            return _Type(np.dtype(object), 4 + self.sizeof_addr + 4, vlen=True)
        raise NotImplementedError(f"HDF5 datatype class {cls}")

    def dataspace(self, pos: int) -> typing.Optional[typing.Tuple[int, ...]]:
        """The shape of a dataspace message; ``None`` for a null one."""
        version, rank = self.data[pos], self.data[pos + 1]
        if version == 1:
            start = pos + 8
        elif version == 2:
            if self.data[pos + 3] == 2:
                return None
            start = pos + 4
        else:
            raise NotImplementedError(f"HDF5 dataspace version {version}")
        return tuple(self.uint(start + i * self.sizeof_size, self.sizeof_size)
                     for i in range(rank))

    def global_heap_object(self, addr: int, index: int) -> bytes:
        heap = self._heaps.get(addr)
        if heap is None:
            self.signature(addr, b"GCOL", "global heap collection")
            heap = {}
            end = addr + self.uint(addr + 8, self.sizeof_size)
            pos = addr + 8 + self.sizeof_size
            while pos + 8 + self.sizeof_size <= end:
                obj_index = self.uint(pos, 2)
                size = self.uint(pos + 8, self.sizeof_size)
                if obj_index == 0:  # the collection's free space
                    break
                start = pos + 8 + self.sizeof_size
                heap[obj_index] = bytes(self.data[start : start + size])
                pos = start + _align8(size)
            self._heaps[addr] = heap
        return heap[index]

    def values(self, pos: int, shape, dtype: _Type, decode: bool) -> np.ndarray:
        """The array of ``shape`` stored at ``pos``; variable-length
        strings as ``str`` if ``decode`` else ``bytes``."""
        count = math.prod(shape)
        if not dtype.vlen:
            array = np.frombuffer(self.data, dtype.dtype, count=count, offset=pos)
            return array.reshape(shape).copy()
        out = np.empty(count, dtype=object)
        for i in range(count):
            item = pos + i * dtype.size
            length = self.uint(item, 4)
            heap = self.address(item + 4)
            if length == 0 or heap is None:
                value = b""
            else:
                index = self.uint(item + 4 + self.sizeof_addr, 4)
                value = self.global_heap_object(heap, index)[:length]
            out[i] = value.decode("utf-8") if decode else value
        return out.reshape(shape)

    # -- attributes ---------------------------------------------------------

    def attributes(self, addr: int) -> dict:
        out = {}
        for mtype, pos, _ in self.messages(addr):
            if mtype == _ATTRIBUTE:
                name, value = self.attribute(pos)
                out[name] = value
            elif mtype == _ATTRIBUTE_INFO:
                flags = self.data[pos + 1]
                heap = pos + 2 + (2 if flags & 0x01 else 0)
                if self.address(heap) is not None:
                    raise NotImplementedError("HDF5 dense attribute storage")
        return dict(sorted(out.items()))

    def attribute(self, pos: int):
        data = self.data
        version = data[pos]
        if version not in (1, 2, 3):
            raise NotImplementedError(f"HDF5 attribute message version {version}")
        if version > 1 and data[pos + 1] & 0x03:
            raise NotImplementedError("HDF5 shared attribute datatypes or dataspaces")
        name_size = self.uint(pos + 2, 2)
        type_size = self.uint(pos + 4, 2)
        space_size = self.uint(pos + 6, 2)
        # Version 1 pads the name, datatype and dataspace to 8 bytes;
        # version 3 adds the name's character set.
        pad = _align8 if version == 1 else (lambda n: n)
        start = pos + (9 if version == 3 else 8)
        name = bytes(data[start : start + name_size]).rstrip(b"\0").decode("utf-8")
        type_pos = start + pad(name_size)
        space_pos = type_pos + pad(type_size)
        raw = space_pos + pad(space_size)
        dtype = self.datatype(type_pos)
        shape = self.dataspace(space_pos)
        if shape is None:
            return name, Empty(dtype.dtype)
        array = self.values(raw, shape, dtype, decode=True)
        return name, array[()] if shape == () else array

    # -- groups -------------------------------------------------------------

    def local_heap_name(self, heap: int, offset: int) -> str:
        self.signature(heap, b"HEAP", "local heap")
        segment = self.address(heap + 8 + 2 * self.sizeof_size)
        start = segment + offset
        end = self.data.index(b"\0", start)
        return bytes(self.data[start:end]).decode("utf-8")

    def group_entries(self, btree: int, heap: int) -> typing.Dict[str, int]:
        """Name -> object-header address of a symbol-table group's members
        (:data:`_SOFT_LINK` for a soft link), in name order."""
        entries: typing.Dict[str, int] = {}
        entry_size = 2 * self.sizeof_addr + 24
        nodes = [btree]
        while nodes:
            node = nodes.pop(0)
            self.signature(node, b"TREE", "B-tree node")
            if self.data[node + 4] != 0:
                raise NotImplementedError("HDF5 chunked data (B-tree type 1)")
            level = self.data[node + 5]
            used = self.uint(node + 6, 2)
            first_child = node + 8 + 2 * self.sizeof_addr + self.sizeof_size
            children = [self.address(first_child + i * (self.sizeof_size + self.sizeof_addr))
                        for i in range(used)]
            if level > 0:
                nodes[:0] = children
                continue
            for snod in children:
                self.signature(snod, b"SNOD", "symbol-table node")
                for i in range(self.uint(snod + 6, 2)):
                    entry = snod + 8 + i * entry_size
                    name = self.local_heap_name(heap, self.uint(entry, self.sizeof_addr))
                    if self.uint(entry + 2 * self.sizeof_addr, 4) == 2:
                        entries[name] = _SOFT_LINK
                    else:
                        entries[name] = self.address(entry + self.sizeof_addr)
        return dict(sorted(entries.items(), key=lambda item: item[0].encode("utf-8")))

    def node(self, addr: int, name: str):
        """The :class:`Group` or :class:`Dataset` whose header is at ``addr``."""
        if addr == _SOFT_LINK:
            raise NotImplementedError(f"HDF5 soft links ({name!r})")
        types = {mtype: pos for mtype, pos, _ in self.messages(addr)}
        for mtype, feature in ((_FILTERS, "filtered data"), (_EXTERNAL, "external data files"),
                               (_LINK, "link messages (new-style groups)"),
                               (_LINK_INFO, "link messages (new-style groups)"),
                               (_GROUP_INFO, "link messages (new-style groups)")):
            if mtype in types:
                raise NotImplementedError(f"HDF5 {feature}")
        if _SYMBOL_TABLE in types:
            pos = types[_SYMBOL_TABLE]
            return Group(self, addr, name, self.address(pos),
                         self.address(pos + self.sizeof_addr))
        if _LAYOUT in types:
            return Dataset(self, addr, name, types)
        raise NotImplementedError(f"HDF5 object {name!r} with no symbol table or data layout")


class _Node:
    def __init__(self, reader: _Reader, addr: int, name: str):
        self._reader = reader
        self._addr = addr
        self.name = name
        self._attrs: typing.Optional[dict] = None

    @property
    def attrs(self) -> typing.Mapping[str, typing.Any]:
        """The object's attributes, in name order."""
        if self._attrs is None:
            self._attrs = self._reader.attributes(self._addr)
        return self._attrs


class Group(_Node):
    """A symbol-table group; members by ``a/b/c`` path, in name order."""

    def __init__(self, reader, addr, name, btree, heap):
        super().__init__(reader, addr, name)
        self._btree, self._heap = btree, heap
        self._entries: typing.Optional[typing.Dict[str, int]] = None

    def _members(self) -> typing.Dict[str, int]:
        if self._entries is None:
            self._entries = self._reader.group_entries(self._btree, self._heap)
        return self._entries

    def __getitem__(self, path: str):
        node: typing.Any = self
        for part in path.split("/"):
            if not part:
                continue
            if not isinstance(node, Group) or part not in node._members():
                raise KeyError(f"{path!r} not found in {self.name!r}")
            child = node.name.rstrip("/") + "/" + part
            node = self._reader.node(node._members()[part], child)
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __iter__(self) -> typing.Iterator[str]:
        return iter(self._members())

    def __len__(self) -> int:
        return len(self._members())

    def keys(self) -> typing.List[str]:
        return list(self._members())

    def visititems(self, func):
        """Call ``func(relative_path, node)`` on every member below, in
        name order, depth first; stop at the first non-None return."""
        for name in self._members():
            node = self[name]
            result = func(name, node)
            if result is not None:
                return result
            if isinstance(node, Group):
                result = node.visititems(lambda sub, obj: func(f"{name}/{sub}", obj))
                if result is not None:
                    return result
        return None


class Dataset(_Node):
    """A contiguous or compact dataset; ``np.asarray(dataset)`` reads it."""

    def __init__(self, reader, addr, name, types):
        super().__init__(reader, addr, name)
        self._type = reader.datatype(types[_DATATYPE])
        shape = reader.dataspace(types[_DATASPACE])
        self.shape = () if shape is None else shape
        self.dtype = self._type.dtype
        self._layout = types[_LAYOUT]

    def _raw(self) -> typing.Tuple[typing.Optional[int], int]:
        """(address, bytes) of the stored data."""
        reader, pos = self._reader, self._layout
        version = reader.data[pos]
        nbytes = math.prod(self.shape) * self._type.size
        if version in (3, 4):
            layout = reader.data[pos + 1]
            if layout == 0:
                return pos + 4, reader.uint(pos + 2, 2)
            if layout == 1:
                return reader.address(pos + 2), nbytes
        elif version in (1, 2):
            rank, layout = reader.data[pos + 1], reader.data[pos + 2]
            if layout == 0:
                size_at = pos + 8 + 4 * rank
                return size_at + 4, reader.uint(size_at, 4)
            if layout == 1:
                return reader.address(pos + 8), nbytes
        else:
            raise NotImplementedError(f"HDF5 data-layout version {version}")
        names = {2: "chunked data", 3: "virtual datasets"}
        raise NotImplementedError(f"HDF5 {names.get(layout, f'data layout {layout}')}")

    def __array__(self, dtype=None, copy=None):
        addr, nbytes = self._raw()
        if addr is None:  # never written: h5py gives the zero fill value
            array = np.zeros(self.shape, dtype=self.dtype)
        else:
            if nbytes < math.prod(self.shape) * self._type.size:
                raise ValueError(f"corrupt HDF5 file: {self.name!r} holds {nbytes} bytes")
            array = self._reader.values(addr, self.shape, self._type, decode=False)
        return array if dtype is None else array.astype(dtype)


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

# Symbol-table node capacity is 2 * _LEAF_K entries; a B-tree node holds
# up to 2 * K children, K at least _INTERNAL_K (h5py's defaults).
_LEAF_K = 4
_INTERNAL_K = 16
_UNDEFINED = b"\xff" * 8
_FREE_NULL = 1  # libhdf5's "no free block" in a local heap's free list


def _writable(value) -> np.ndarray:
    array = np.asarray(value)
    if array.dtype.kind not in "iufS" or (array.dtype.kind == "f" and array.itemsize not in _IEEE):
        raise TypeError(f"cannot write dtype {array.dtype} to HDF5 (numbers and bytes only)")
    return array


class _NewGroup:
    def __init__(self):
        self.attrs: typing.Dict[str, np.ndarray] = _Attrs()
        self.members: typing.Dict[str, typing.Any] = {}

    def _parent(self, path: str) -> typing.Tuple["_NewGroup", str]:
        *parents, last = [part for part in path.split("/") if part]
        node = self
        for part in parents:
            node = node.members.setdefault(part, _NewGroup())
            if not isinstance(node, _NewGroup):
                raise ValueError(f"{part!r} of {path!r} is a dataset")
        if last in node.members:
            raise ValueError(f"{path!r} exists")
        return node, last

    def create_group(self, path: str) -> "_NewGroup":
        parent, name = self._parent(path)
        group = parent.members[name] = _NewGroup()
        return group

    def create_dataset(self, path: str, data) -> "_NewDataset":
        parent, name = self._parent(path)
        dataset = parent.members[name] = _NewDataset(_writable(data))
        return dataset


class _NewDataset:
    def __init__(self, data: np.ndarray):
        self.data = data
        self.attrs: typing.Dict[str, np.ndarray] = _Attrs()


class _Attrs(dict):
    def __setitem__(self, name, value):
        super().__setitem__(name, _writable(value))


def _datatype_message(dtype: np.dtype) -> bytes:
    order = 1 if dtype.byteorder == ">" else 0
    size = dtype.itemsize
    if dtype.kind == "S":
        return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, size)  # null-padded ASCII
    if dtype.kind in "iu":
        bits = order | (0x08 if dtype.kind == "i" else 0)
        return struct.pack("<BBBBIHH", 0x10, bits, 0, 0, size, 0, 8 * size)
    sign, exp_loc, exp_size, mant_loc, mant_size, bias = _IEEE[size]
    # Mantissa normalisation 2 (the leading 1 implied), then the sign bit.
    return struct.pack("<BBBBIHHBBBBI", 0x11, order | 0x20, sign, 0, size, 0, 8 * size,
                       exp_loc, exp_size, mant_loc, mant_size, bias)


def _dataspace_message(shape: typing.Tuple[int, ...]) -> bytes:
    return struct.pack("<BBBB4x", 1, len(shape), 0, 0) + b"".join(
        struct.pack("<Q", n) for n in shape)


def _pad8(raw: bytes) -> bytes:
    return raw + b"\0" * (_align8(len(raw)) - len(raw))


def _attribute_message(name: str, value: np.ndarray) -> bytes:
    """A version-1 attribute message: name, datatype and dataspace each
    padded to 8 bytes, then the data."""
    encoded = name.encode("utf-8") + b"\0"
    datatype = _datatype_message(value.dtype)
    dataspace = _dataspace_message(value.shape)
    head = struct.pack("<BBHHH", 1, 0, len(encoded), len(datatype), len(dataspace))
    message = head + _pad8(encoded) + _pad8(datatype) + _pad8(dataspace) + value.tobytes()
    if len(message) > 0xFFFF:
        raise ValueError(f"attribute {name!r} is larger than one object-header message")
    return message


class _Writer:
    """Appends a file's structures children first, so that every address
    a structure holds is known when it is written."""

    def __init__(self, f, internal_k: int):
        self.f = f
        self.end = 0
        self.internal_k = internal_k

    def append(self, raw) -> int:
        addr = self.end
        self.f.write(raw)
        self.end += len(memoryview(raw).cast("B"))
        pad = _align8(self.end) - self.end
        self.f.write(b"\0" * pad)
        self.end += pad
        return addr

    def header(self, messages: typing.List[typing.Tuple[int, bytes]]) -> int:
        body = b"".join(struct.pack("<HHB3x", mtype, _align8(len(raw)), 0) + _pad8(raw)
                        for mtype, raw in messages)
        prefix = struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body))
        return self.append(prefix + body)

    def attributes(self, attrs) -> typing.List[typing.Tuple[int, bytes]]:
        return [(_ATTRIBUTE, _attribute_message(name, value)) for name, value in attrs.items()]

    def dataset(self, node: _NewDataset) -> int:
        data = np.asarray(node.data, order="C")  # ascontiguousarray would make a scalar 1-D
        if data.nbytes:
            addr = struct.pack("<Q", self.append(data.reshape(-1).view(np.uint8)))
        else:
            addr = _UNDEFINED
        layout = struct.pack("<BB", 3, 1) + addr + struct.pack("<Q", data.nbytes)
        return self.header([(_DATASPACE, _dataspace_message(data.shape)),
                            (_DATATYPE, _datatype_message(data.dtype)),
                            (_LAYOUT, layout)] + self.attributes(node.attrs))

    def group(self, node: _NewGroup) -> typing.Tuple[int, int, int]:
        """Writes ``node`` and its members; (header, B-tree, heap) addresses."""
        entries = []
        for name in sorted(node.members, key=lambda n: n.encode("utf-8")):
            member = node.members[name]
            if isinstance(member, _NewGroup):
                header, btree, heap = self.group(member)
                scratch = (1, struct.pack("<QQ", btree, heap))
            else:
                header, scratch = self.dataset(member), (0, b"\0" * 16)
            entries.append((name.encode("utf-8"), header, scratch))
        # The local heap: "" at offset 0, then each name, 8-byte padded.
        segment = bytearray(8)
        offsets = []
        for name, _, _ in entries:
            offsets.append(len(segment))
            segment += _pad8(name + b"\0")
        heap = self.append(b"HEAP" + struct.pack("<B3xQQQ", 0, len(segment), _FREE_NULL,
                                                  self.end + 32) + segment)
        capacity = 2 * _LEAF_K
        nodes = []
        for first in range(0, len(entries), capacity):
            chunk = entries[first : first + capacity]
            raw = bytearray(b"SNOD" + struct.pack("<BBH", 1, 0, len(chunk)))
            for (_, header, (cache, scratch)), offset in zip(chunk, offsets[first:]):
                raw += struct.pack("<QQI4x", offset, header, cache) + scratch
            raw += b"\0" * (capacity - len(chunk)) * 40
            nodes.append((self.append(bytes(raw)), offsets[first + len(chunk) - 1]))
        # One leaf B-tree node: key 0 is "", key i + 1 the last name of
        # symbol-table node i.
        raw = bytearray(b"TREE" + struct.pack("<BBH", 0, 0, len(nodes)) + _UNDEFINED * 2)
        raw += struct.pack("<Q", 0)
        for addr, last in nodes:
            raw += struct.pack("<QQ", addr, last)
        raw += b"\0" * (2 * self.internal_k - len(nodes)) * 16
        btree = self.append(bytes(raw))
        stab = struct.pack("<QQ", btree, heap)
        header = self.header([(_SYMBOL_TABLE, stab)] + self.attributes(node.attrs))
        return header, btree, heap


def _most_nodes(node: _NewGroup) -> int:
    """The most symbol-table nodes any group below ``node`` needs."""
    own = -(-len(node.members) // (2 * _LEAF_K))
    subgroups = [m for m in node.members.values() if isinstance(m, _NewGroup)]
    return max([own] + [_most_nodes(g) for g in subgroups])


def _write_file(path, root: _NewGroup):
    internal_k = max(_INTERNAL_K, -(-_most_nodes(root) // 2))
    superblock_size = 56 + 40  # fields and addresses, root symbol-table entry
    with open(path, "wb") as f:
        writer = _Writer(f, internal_k)
        writer.append(b"\0" * superblock_size)
        header, btree, heap = writer.group(root)
        superblock = (SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0,
                                              _LEAF_K, internal_k, 0)
                      + struct.pack("<Q", 0) + _UNDEFINED + struct.pack("<Q", writer.end)
                      + _UNDEFINED + struct.pack("<QQI4xQQ", 0, header, 1, btree, heap))
        f.seek(0)
        f.write(superblock)


# ---------------------------------------------------------------------------
# The file object
# ---------------------------------------------------------------------------


class File:
    """An HDF5 file: ``File(path)`` reads, ``File(path, "w")`` builds one
    that is written when the file is closed (or its ``with`` block ends
    without an exception).

    Reading loads the whole file into memory; groups, datasets and
    attributes are decoded when first used.
    """

    def __init__(self, path: typing.Union[str, os.PathLike], mode: str = "r"):
        self.filename = os.fspath(path)
        self.mode = mode
        if mode == "r":
            with open(self.filename, "rb") as f:
                reader = _Reader(f.read())
            self._root = reader.node(reader.root, "/")
        elif mode == "w":
            self._root = _NewGroup()
        else:
            raise ValueError(f"mode {mode!r}: only 'r' and 'w' are supported")
        self._open = True

    def __getattr__(self, name):
        return getattr(self.__dict__["_root"], name)

    def __getitem__(self, path: str):
        return self._root[path]

    def __contains__(self, path: str) -> bool:
        return path in self._root

    def __iter__(self):
        return iter(self._root)

    def __len__(self) -> int:
        return len(self._root)

    def close(self):
        if self._open and self.mode == "w":
            _write_file(self.filename, self._root)
        self._open = False

    def __enter__(self) -> "File":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        self._open = False
