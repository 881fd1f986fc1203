"""Write the GIF fixtures that ``tests/test_torch_gif.py`` and
``chip_smoke.py`` read, with PIL's decodes and JPEG files as their hashes.

    python scripts/make_gif_fixtures.py [--out tests/fixtures/gif]

Each fixture is a small GIF written by :func:`write_gif` (a GIF writer of
its own, so that a file can hold what PIL's writer does not produce: a
chosen LZW code size, a table that fills without a clear code, a partial
first frame, a local palette); ``hashes.json`` beside them holds, for
each, the sha256 of ``np.array(PIL.Image.open(f).convert("RGB"))`` and of
the bytes of ``PIL.Image.open(f).convert("RGB").save(x.jpg)``, plus the
shape. The script needs PIL; the files it writes do not.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct

import numpy as np


def lzw_codes(indices: bytes, min_size: int, clear_when_full: bool = True):
    """(code, bit width) pairs of the GIF LZW stream of ``indices``: a clear
    code first, then the codes, then the end code. Where the table fills
    (4096 codes), a clear code follows, or with ``clear_when_full=False``
    the table stays full and codes keep 12 bits (a deferred clear)."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out = []
    state = {"next": end + 1, "size": min_size + 1, "first": True}

    def emit(code):
        out.append((code, state["size"]))
        if code == clear:
            state.update(next=end + 1, size=min_size + 1, first=True)
            return
        if not state["first"] and state["next"] < 4096:
            state["next"] += 1
            if state["next"] == 1 << state["size"] and state["size"] < 12:
                state["size"] += 1
        state["first"] = False

    def fresh():
        return {bytes([i]): i for i in range(clear)}, end + 1

    table, nxt = fresh()
    emit(clear)
    word = b""
    for value in indices:
        pixel = bytes([value])
        if word + pixel in table:
            word += pixel
            continue
        emit(table[word])
        if nxt < 4096:
            table[word + pixel] = nxt
            nxt += 1
        elif clear_when_full:
            emit(clear)
            table, nxt = fresh()
        word = pixel
    if word:
        emit(table[word])
    emit(end)
    return out


def pack_codes(codes) -> bytes:
    """LSB-first bit packing of (code, width) pairs, in 255-byte sub-blocks
    ending with the zero-length block."""
    acc = nbits = 0
    data = bytearray()
    for code, width in codes:
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            data.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
    if nbits:
        data.append(acc & 0xFF)
    blocks = bytearray()
    for start in range(0, len(data), 255):
        chunk = data[start:start + 255]
        blocks += bytes([len(chunk)]) + chunk
    return bytes(blocks + b"\x00")


def _palette_bytes(palette) -> tuple:
    palette = np.asarray(palette, np.uint8).reshape(-1, 3)
    bits = max(1, int(np.ceil(np.log2(max(len(palette), 2)))))
    table = np.zeros((1 << bits, 3), np.uint8)
    table[:len(palette)] = palette
    return bits, table.tobytes()



def _interlace_order(height: int):
    return ([*range(0, height, 8)] + [*range(4, height, 8)] + [*range(2, height, 4)]
            + [*range(1, height, 2)])


def write_gif(indices, screen=None, global_palette=None, local_palette=None, offset=(0, 0),
              min_size=None, interlace=False, transparency=None, background=0,
              clear_when_full=True, version=b"GIF89a", frames=()) -> bytes:
    """A GIF of one frame of palette ``indices`` ((h, w) uint8) at
    ``offset`` on a logical screen ``screen`` = (width, height) (default the
    frame's), with a global and/or local palette ((n, 3) uint8), LZW
    minimum code size ``min_size`` (default the palette's bits, at least
    2), optional interlacing and a graphic-control extension naming a
    transparent index. ``frames`` are more (indices, offset) frames after
    the first, which a first-frame reader skips."""
    indices = np.asarray(indices, np.uint8)
    height, width = indices.shape
    screen = screen or (width, height)
    out = bytearray(version)
    flags = 0
    gbits = 1
    if global_palette is not None:
        gbits, gtable = _palette_bytes(global_palette)
        flags = 0x80 | 0x70 | (gbits - 1)
    out += struct.pack("<HHBBB", screen[0], screen[1], flags, background, 0)
    if global_palette is not None:
        out += gtable
    for number, (frame, place) in enumerate([(indices, offset), *frames]):
        frame = np.asarray(frame, np.uint8)
        fh, fw = frame.shape
        if transparency is not None or number:
            flag = 1 if transparency is not None else 0
            out += b"\x21\xf9\x04" + struct.pack("<BHB", flag, 10, transparency or 0) + b"\x00"
        lflags = 0x40 if interlace else 0
        lbits = None
        if local_palette is not None and number == 0:
            lbits, ltable = _palette_bytes(local_palette)
            lflags |= 0x80 | (lbits - 1)
        out += b"\x2c" + struct.pack("<HHHHB", place[0], place[1], fw, fh, lflags)
        if lbits is not None:
            out += ltable
        size = min_size or max(2, lbits or gbits)
        rows = frame[_interlace_order(fh)] if interlace else frame
        out += bytes([size]) + pack_codes(lzw_codes(rows.tobytes(), size, clear_when_full))
    return bytes(out + b"\x3b")


def fixture_gifs() -> dict:
    """The fixtures: name -> GIF bytes. Each stays under 12 KB."""
    rng = np.random.RandomState(20)
    colours = rng.randint(0, 256, (256, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:96, :128]
    smooth = ((xx // 8 + yy // 8) % 16).astype(np.uint8)
    noise = rng.randint(0, 256, (80, 120)).astype(np.uint8)
    grey = np.arange(256, dtype=np.uint8)[:, None].repeat(3, 1)
    return {
        "global_interlaced.gif": write_gif(smooth, global_palette=colours[:16],
                                           interlace=True),
        "local_transparent.gif": write_gif(
            smooth[:60, :90], screen=(128, 96), offset=(20, 18), global_palette=colours[:4],
            local_palette=colours[16:32], transparency=5, background=2),
        "code_size_2.gif": write_gif((smooth % 4)[:64, :64], global_palette=colours[:4],
                                     min_size=2),
        "deferred_clear_8bit.gif": write_gif(noise, global_palette=colours, min_size=8,
                                             clear_when_full=False),
        "grey_partial.gif": write_gif((noise // 2)[:40, :50], screen=(64, 48), offset=(7, 5),
                                      global_palette=grey, background=9, version=b"GIF87a"),
    }


def pil_hashes(blob: bytes) -> dict:
    from PIL import Image

    image = Image.open(io.BytesIO(blob)).convert("RGB")
    pixels = np.array(image)
    jpeg = io.BytesIO()
    image.save(jpeg, format="JPEG")
    return {"shape": list(pixels.shape),
            "decoded_sha256": hashlib.sha256(pixels.tobytes()).hexdigest(),
            "jpeg_sha256": hashlib.sha256(jpeg.getvalue()).hexdigest(),
            "jpeg_decoded_sha256": hashlib.sha256(
                np.array(Image.open(io.BytesIO(jpeg.getvalue())).convert("RGB")).tobytes()
            ).hexdigest()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.abspath(__file__))
    parser.add_argument("--out", default=os.path.join(here, "..", "tests", "fixtures", "gif"))
    args = parser.parse_args()
    os.makedirs(args.out, exist_ok=True)
    hashes = {}
    for name, blob in fixture_gifs().items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(blob)
        hashes[name] = pil_hashes(blob)
        print(name, len(blob), "bytes", hashes[name]["decoded_sha256"])
    with open(os.path.join(args.out, "hashes.json"), "w") as f:
        json.dump(hashes, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
