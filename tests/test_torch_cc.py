"""Port parity: connected-component sweeps and labeling vs the JAX package.

The port's sweep wrapper runs its plain PyTorch version for CPU tensors;
it must equal ``keras_ocr_tpu.ops.cc.segmented_min_sweeps`` and the Pallas
kernel (interpret mode) exactly, converged flags included. The labeling
functions built on it must be exact too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keras_ocr_tpu.ops import cc as jcc
from keras_ocr_tpu.ops.cc_pallas import segmented_min_sweeps_pallas
from keras_ocr_tpu_torch.ops import cc, cc_cuda

torch.set_num_threads(2)


def _serpentine(height, width):
    fg = np.zeros((height, width), bool)
    for i, row in enumerate(range(1, height - 1, 2)):
        fg[row, 2 : width - 2] = True
        if row + 2 < height - 1:
            fg[row + 1, width - 3 if i % 2 == 0 else 2] = True
    return fg


def _masks():
    rng = np.random.RandomState(0)
    masks = [rng.rand(96, 160) < density for density in (0.4, 0.6, 0.8)]
    return masks + [_serpentine(96, 160)]


def _label_inputs(fg):
    sentinel = fg.size
    idx = np.arange(sentinel, dtype=np.int32).reshape(fg.shape)
    return np.where(fg, idx, sentinel).astype(np.int32), (~fg).astype(np.int32), sentinel


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("sweeps", [1, 8])
def test_sweeps_match_jax_and_pallas(case, sweeps):
    fg = _masks()[case]
    values, barrier, sentinel = _label_inputs(fg)
    ref, ref_conv = jcc.segmented_min_sweeps(
        jnp.asarray(values), jnp.asarray(barrier), sentinel, sweeps, check_convergence=True
    )
    out, conv = cc.segmented_min_sweeps(
        torch.from_numpy(values), torch.from_numpy(barrier), sentinel, sweeps,
        check_convergence=True,
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert bool(conv) == bool(ref_conv)
    pallas = segmented_min_sweeps_pallas(
        jnp.asarray(values), jnp.asarray(barrier), sentinel, sweeps, interpret=True
    )
    plain = cc.segmented_min_sweeps(
        torch.from_numpy(values), torch.from_numpy(barrier), sentinel, sweeps
    )
    np.testing.assert_array_equal(plain.numpy(), np.asarray(pallas))


def test_sweeps_batched_equal_per_image():
    """A (B, H, W) batch equals its images swept one by one, flags per image."""
    masks = np.stack(_masks())
    values, barrier, sentinel = _label_inputs(masks[0])
    values = np.where(masks, np.arange(sentinel).reshape(96, 160), sentinel).astype(np.int32)
    barrier = (~masks).astype(np.int32)
    out, conv = cc.segmented_min_sweeps(
        torch.from_numpy(values), torch.from_numpy(barrier), sentinel, 8, True
    )
    assert conv.shape == (4,)
    for i in range(4):
        one, one_conv = cc.segmented_min_sweeps(
            torch.from_numpy(values[i]), torch.from_numpy(barrier[i]), sentinel, 8, True
        )
        assert torch.equal(out[i], one) and bool(conv[i]) == bool(one_conv)
    assert not bool(conv[3])  # the serpentine needs more than 8 sweeps


def test_cpu_tensors_take_the_plain_version_without_counting():
    values, barrier, sentinel = _label_inputs(_masks()[0])
    before = cc_cuda.segmented_min_sweeps.launches
    cc_cuda.segmented_min_sweeps(torch.from_numpy(values), torch.from_numpy(barrier), sentinel, 2)
    assert cc_cuda.segmented_min_sweeps.launches == before
    with pytest.raises(ValueError):
        cc_cuda.segmented_min_sweeps(
            torch.from_numpy(values).to("meta"), torch.from_numpy(barrier).to("meta"),
            sentinel, 2,
        )


BARRIER_TYPES = [torch.bool, torch.uint8, torch.int32]


@pytest.mark.parametrize("dtype", BARRIER_TYPES, ids=str)
def test_sweeps_take_any_barrier_type(dtype):
    """A bool, a uint8 and an int32 barrier give the same maps and flags,
    those of the JAX package."""
    fg = _masks()[1]
    values, barrier, sentinel = _label_inputs(fg)
    ref, ref_conv = jcc.segmented_min_sweeps(
        jnp.asarray(values), jnp.asarray(barrier), sentinel, 3, check_convergence=True
    )
    out, conv = cc_cuda.segmented_min_sweeps(
        torch.from_numpy(values), torch.from_numpy(~fg).to(dtype), sentinel, 3, True
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert bool(conv) == bool(ref_conv)


@pytest.mark.parametrize("dtype", BARRIER_TYPES, ids=str)
def test_keyed_rows_cols_take_any_mask_type(dtype):
    """The keyed entry's foreground as bool, uint8 or int32 gives the map of
    the JAX package's ``_keyed_run_min`` along the rows, then the columns."""
    rng = np.random.RandomState(3)
    fg = rng.rand(48, 80) < 0.6
    key = np.where(fg, rng.randint(0, 3, size=fg.shape), -1).astype(np.int32)
    values, _, sentinel = _label_inputs(fg)
    jkey, jfg = jnp.asarray(key), jnp.asarray(fg)
    ref = jcc._keyed_run_min(jnp.asarray(values), jkey, jfg, sentinel, 1)
    ref = jcc._keyed_run_min(ref, jkey, jfg, sentinel, 0)
    out = cc_cuda.keyed_rows_cols(
        torch.from_numpy(values), torch.from_numpy(key), torch.from_numpy(fg).to(dtype),
        sentinel,
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _fixpoint_schedule(values, barrier, sentinel, num_sweeps):
    """The card's schedule in plain PyTorch: sweeps one at a time, and each
    image stops after its first sweep that changed nothing. ``flags[s, b]``
    says sweep s changed image b; the last sweep is the convergence check."""
    flags = torch.zeros((num_sweeps + 1, values.shape[0]), dtype=torch.int32)
    out = values.clone()
    for b in range(values.shape[0]):
        for s in range(num_sweeps + 1):
            if s > 0 and not flags[s - 1, b]:
                break
            swept = cc_cuda.segmented_min_sweeps_plain(out[b], barrier[b], sentinel, 1)
            flags[s, b] = int(not torch.equal(swept, out[b]))
            out[b] = swept
    return out, flags[num_sweeps] == 0


@pytest.mark.parametrize("sweeps", [0, 1, 8])
def test_fixpoint_stop_matches_jax(sweeps):
    """Stopping each image at its fixpoint gives the JAX package's maps and
    converged flags, on images that converge at different sweeps."""
    single = np.zeros((96, 160), bool)
    single[40, 70] = True
    masks = np.stack(_masks() + [np.zeros((96, 160), bool), single])
    sentinel = masks[0].size
    values = np.where(masks, np.arange(sentinel).reshape(96, 160), sentinel).astype(np.int32)
    barrier = ~masks
    out, conv = _fixpoint_schedule(
        torch.from_numpy(values), torch.from_numpy(barrier), sentinel, sweeps
    )
    for b in range(len(masks)):
        ref, ref_conv = jcc.segmented_min_sweeps(
            jnp.asarray(values[b]), jnp.asarray(barrier[b].astype(np.int32)), sentinel,
            sweeps, check_convergence=True,
        )
        np.testing.assert_array_equal(out[b].numpy(), np.asarray(ref))
        assert bool(conv[b]) == bool(ref_conv)
    assert bool(conv[4]) and bool(conv[5])  # the empty and one-pixel images
    assert not bool(conv[3])  # the serpentine


@pytest.mark.parametrize("case", range(4))
def test_label_and_compact_match_jax(case):
    fg = _masks()[case]
    for sweeps in (2, 8):
        ref, ref_conv = jcc.label_components(
            jnp.asarray(fg), num_sweeps=sweeps, check_convergence=True
        )
        out, conv = cc.label_components(
            torch.from_numpy(fg), num_sweeps=sweeps, check_convergence=True
        )
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        assert bool(conv) == bool(ref_conv)
        for cap in (4, 64):
            rc, rn, rconv = jcc.compact_labels(
                ref, cap, num_sweeps=sweeps, check_convergence=True
            )
            oc, on, oconv = cc.compact_labels(
                out, cap, num_sweeps=sweeps, check_convergence=True
            )
            np.testing.assert_array_equal(oc.numpy(), np.asarray(rc))
            assert int(on) == int(rn)
            assert bool(oconv) == bool(rconv)


@pytest.mark.parametrize("seed", [0, 1])
def test_brushfire_and_keyed_blobs_match_jax(seed):
    rng = np.random.RandomState(seed)
    height, width = 48, 80
    seed_mask = rng.rand(height, width) < 0.05
    comp = rng.randint(0, 6, size=(height, width)).astype(np.int32)
    grow_a = rng.randint(0, 4, size=(height, width)).astype(np.float32)
    grow_b = rng.randint(0, 4, size=(height, width)).astype(np.float32)
    ref_cover, ref_comp = jcc.brushfire_dilate(
        jnp.asarray(seed_mask), jnp.asarray(comp), jnp.asarray(grow_a), jnp.asarray(grow_b)
    )
    cover, cover_comp = cc.brushfire_dilate(
        torch.from_numpy(seed_mask), torch.from_numpy(comp),
        torch.from_numpy(grow_a), torch.from_numpy(grow_b),
    )
    np.testing.assert_array_equal(cover.numpy(), np.asarray(ref_cover))
    np.testing.assert_array_equal(cover_comp.numpy(), np.asarray(ref_comp))
    for sweeps in (1, 8):
        ref, ref_conv = jcc.label_blobs_keyed(
            ref_cover, ref_comp, num_sweeps=sweeps, check_convergence=True
        )
        out, conv = cc.label_blobs_keyed(
            cover, cover_comp, num_sweeps=sweeps, check_convergence=True
        )
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        assert bool(conv) == bool(ref_conv)


def _mega_snake(height=42, width=40):
    fg = np.zeros((height, width), bool)
    for i, row in enumerate(range(1, height - 1, 2)):
        fg[row, 2 : width - 2] = True
        if row + 2 < height - 1:
            fg[row + 1, width - 3 if i % 2 == 0 else 2] = True
    return fg


def _refine_masks():
    """A sparse and a dense seeded mask, the serpentine and the mega snake,
    each with a blocky 4-connected-id stand-in for ``comp``."""
    masks = [_masks()[0], _masks()[2], _masks()[3], _mega_snake()]
    out = []
    for fg in masks:
        yy, xx = np.mgrid[0 : fg.shape[0], 0 : fg.shape[1]]
        comp = np.where(fg, (yy // 9 * 5 + xx // 13) % 4, -1).astype(np.int32)
        out.append((fg, comp))
    return out


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("sweeps", [1, 8, 32])
def test_label_8conn_matches_jax(case, sweeps):
    fg, comp = _refine_masks()[case]
    for key in (None, comp):
        ref, ref_conv = jcc.label_components_8conn(
            jnp.asarray(fg), num_sweeps=sweeps, comp=None if key is None else jnp.asarray(key),
            check_convergence=True,
        )
        out, conv = cc.label_components_8conn(
            torch.from_numpy(fg), num_sweeps=sweeps,
            comp=None if key is None else torch.from_numpy(key), check_convergence=True,
        )
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        assert bool(conv) == bool(ref_conv)
    if case >= 2:  # the snakes need more than 8 sweeps
        assert bool(conv) == (sweeps == 32 and case == 3)


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("sweeps", [1, 8, 32])
def test_flood_matches_jax(case, sweeps):
    fg, _ = _refine_masks()[case]
    border = np.zeros(fg.shape, bool)
    border[0], border[-1], border[:, 0], border[:, -1] = True, True, True, True
    seeds = border | (np.random.RandomState(case).rand(*fg.shape) < 0.002)
    ref, ref_conv = jcc.flood_from_seeds(
        jnp.asarray(fg), jnp.asarray(seeds), num_sweeps=sweeps, check_convergence=True
    )
    out, conv = cc.flood_from_seeds(
        torch.from_numpy(fg), torch.from_numpy(seeds), num_sweeps=sweeps, check_convergence=True
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert bool(conv) == bool(ref_conv)


def test_8conn_and_flood_batched_equal_per_image():
    """A (2, 3, H, W) batch equals its maps one by one, flags per map."""
    fg = np.stack([m for m, _ in _refine_masks()[:3]] * 2).reshape(2, 3, 96, 160)
    comp = np.stack([c for _, c in _refine_masks()[:3]] * 2).reshape(2, 3, 96, 160)
    seeds = np.zeros_like(fg)
    seeds[..., 0, :] = True
    fg_t, comp_t, seeds_t = map(torch.from_numpy, (fg, comp, seeds))
    label, conv = cc.label_components_8conn(fg_t, 4, comp=comp_t, check_convergence=True)
    flood, fconv = cc.flood_from_seeds(fg_t, seeds_t, 4, check_convergence=True)
    assert conv.shape == fconv.shape == (2, 3)
    for i in range(2):
        for j in range(3):
            one, one_conv = cc.label_components_8conn(
                fg_t[i, j], 4, comp=comp_t[i, j], check_convergence=True
            )
            assert torch.equal(label[i, j], one) and bool(conv[i, j]) == bool(one_conv)
            one, one_conv = cc.flood_from_seeds(fg_t[i, j], seeds_t[i, j], 4, check_convergence=True)
            assert torch.equal(flood[i, j], one) and bool(fconv[i, j]) == bool(one_conv)
