"""K2 over several stores in one call (``extract_patches_stores``), on the CPU.

On CPU stores the wrapper runs K2's plain version per store; those windows
are held here against the JAX package's ``extract_patches_xla`` and
``extract_patches_pallas`` (interpret mode), per subject, byte for byte.
The CUDA kernel's launch plan (``plan_gather``) is held by an emulation of
its walk, in numpy, over every block of the plan: every output byte of
every store written exactly once, from the right source byte, and no load
or stage read outside its piece's slot.  The kernel itself is held against
the plain version on the card (``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py``).  Tolerance: byte-equal throughout (pure data movement,
casts rounded once to nearest even as on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mednet.data import MemoryReader as JaxMemoryReader
from tpu_mednet.data.device_sampler import DevicePatchSampler as JaxSampler
from tpu_mednet.ops.pallas.patches import extract_patches_pallas, extract_patches_xla
from tpu_mednet_torch.data import DevicePatchSampler, MemoryReader
from tpu_mednet_torch.ops import patches as P

PATCH = (4, 5, 7)


def _stores(c, seed=0):
    """A bf16 image store and a uint8 label store of C channels, 3 subjects."""
    rng = np.random.default_rng(seed)
    image = torch.from_numpy(rng.normal(size=(3, 9, 8, 13, c)).astype(np.float32))
    label = torch.from_numpy(rng.integers(0, 256, size=(3, 9, 8, 13, c)).astype(np.uint8))
    corners = np.array([[0, 0, 0], [5, 3, 6], [2, 1, 3], [5, 3, 1], [1, 2, 5]], np.int32)
    subjects = np.array([2, 0, 1, 2, 0], np.int32)
    return image.to(torch.bfloat16), label, corners, subjects


def _jax_windows(store: np.ndarray, corners, subjects, patch):
    """Both JAX gathers, a window at a time from its subject's volume."""
    for gather in (extract_patches_xla,
                   lambda v, c, p: extract_patches_pallas(v, c, p, interpret=True)):
        yield np.concatenate([np.asarray(gather(jnp.asarray(store[s]), jnp.asarray(c[None]),
                                                patch))
                              for c, s in zip(corners, subjects)])


@pytest.mark.parametrize("c", [1, 4])
def test_extract_patches_stores_match_xla_and_pallas(c):
    image, label, corners, subjects = _stores(c)
    got_image, got_label = P.extract_patches_stores((image, label), corners, PATCH, subjects)
    assert got_image.dtype == torch.bfloat16 and got_label.dtype == torch.uint8
    assert got_image.shape == got_label.shape == (len(corners), *PATCH, c)
    image_np = image.view(torch.int16).numpy().view(jnp.bfloat16)
    for ref in _jax_windows(image_np, corners, subjects, PATCH):
        assert ref.dtype == jnp.bfloat16
        np.testing.assert_array_equal(got_image.view(torch.int16).numpy(), ref.view(np.int16))
    for ref in _jax_windows(label.numpy(), corners, subjects, PATCH):
        np.testing.assert_array_equal(got_label.numpy(), ref)


@pytest.mark.parametrize("c", [1, 4])
def test_extract_patches_stores_fuse_each_stores_cast(c):
    image, label, corners, subjects = _stores(c, seed=1)
    got = P.extract_patches_stores((image, label), corners, PATCH, subjects,
                                   out_dtypes=(torch.float32, None))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.uint8
    image_np = image.view(torch.int16).numpy().view(jnp.bfloat16)
    ref = next(_jax_windows(image_np, corners, subjects, PATCH)).astype(np.float32)
    np.testing.assert_array_equal(got[0].numpy(), ref)
    assert torch.equal(got[1], P.extract_patches(label, corners, PATCH, subjects=subjects))


def test_extract_patches_stores_of_volumes_without_subjects():
    image, label, corners, _ = _stores(2)
    got = P.extract_patches_stores((image[1], label[1]), corners, PATCH, None)
    for out, store in zip(got, (image[1], label[1])):
        assert torch.equal(out, P.extract_patches(store, corners, PATCH))


def test_sampler_gathers_both_stores_in_one_call(monkeypatch):
    """``DevicePatchSampler.gather`` makes one ``extract_patches_stores``
    call a batch and no single-store call, and its batches stay byte-equal
    to the JAX sampler's."""
    rng = np.random.default_rng(7)
    shapes = ((14, 12, 16), (12, 15, 13))
    store = {"images": {}, "labels": {}}
    for i, shape in enumerate(shapes):
        lbl = (rng.random((1, *shape)) > 0.7).astype(np.uint8)
        store["images"][f"s{i}"] = rng.normal(size=(1, *shape)).astype(np.float32) + lbl
        store["labels"][f"s{i}"] = lbl
    kw = dict(subject_keys=["s0", "s1"], samples_per_subject=3, patch_size=(6, 5, 7),
              class_probabilities=(0.5, 0.5), seed=2)
    ref = JaxSampler(None, reader=JaxMemoryReader(store), **kw)
    port = DevicePatchSampler(None, reader=MemoryReader(store), device="cpu", **kw)
    calls = []
    stores_call = P.extract_patches_stores
    monkeypatch.setattr(P, "extract_patches_stores",
                        lambda *a, **k: calls.append(1) or stores_call(*a, **k))
    monkeypatch.setattr(P, "extract_patches", lambda *a, **k: pytest.fail("single-store call"))
    n = 0
    for a, b in zip(ref.batches(2), port.batches(2)):
        data = b["data"].permute(0, 2, 3, 4, 1).contiguous()
        np.testing.assert_array_equal(data.view(torch.int16).numpy(),
                                      np.asarray(a["data"]).view(np.int16))
        np.testing.assert_array_equal(b["label"].permute(0, 2, 3, 4, 1).numpy(),
                                      np.asarray(a["label"]))
        n += 1
    assert n == 3 and len(calls) == 3


@pytest.mark.parametrize("case,match", [
    ("subject_count", "differ in subject count or extent"),
    ("extent", "differ in subject count or extent"),
    ("uint8_cast", "only copied"),
    ("volume_with_subjects", r"\(S, X, Y, Z, C\) with subjects"),
    ("out_dtypes", "2 out_dtypes for 1 stores"),
    ("devices", "different devices"),
    ("meta", "CUDA or CPU"),
])
def test_extract_patches_stores_refusals(case, match):
    image, label, corners, subjects = _stores(1)
    stores, kw = [image, label], {}
    if case == "subject_count":
        stores[1] = label[:2]
    elif case == "extent":
        stores[1] = label[:, :, :, :12]
    elif case == "uint8_cast":
        kw["out_dtypes"] = (None, torch.float32)
    elif case == "volume_with_subjects":
        stores = [image[0], label[0]]
    elif case == "out_dtypes":
        stores, kw["out_dtypes"] = [image], (None, None)
    elif case == "devices":
        stores[1] = torch.empty(label.shape, dtype=torch.uint8, device="meta")
    elif case == "meta":
        stores = [torch.empty(s.shape, dtype=s.dtype, device="meta") for s in stores]
    with pytest.raises(ValueError, match=match):
        P.extract_patches_stores(stores, corners, PATCH, subjects, **kw)


# -- the CUDA kernel's launch plan, emulated ---------------------------------

def _emulate(store: np.ndarray, windows, patch, plan, in_dtype, out_dtype, phases):
    """``gather_stores_kernel``'s walk of one store, as csrc/patches.cu does
    it (its divisions by ``fast_divisor``), over byte addresses: the store's
    bytes at ``phases[0]`` past a 16-byte boundary, the output's at
    ``phases[1]`` (each a multiple of its element size).  Returns the output
    and how many times each output byte was written."""
    px, py, pz = patch
    es = store.itemsize
    subjects_bytes, xe, ye, ze, c = store[0].nbytes, *store.shape[1:]
    tin, tout = plan.in_size, plan.out_size
    src_base, out_base = 16 + phases[0], 16 + phases[1]
    mem = np.full(src_base + store.nbytes + 32, 0xEE, np.uint8)
    mem[src_base:src_base + store.nbytes] = store.reshape(-1).view(np.uint8)
    n = len(windows)
    out_bytes = n * px * py * pz * c * np.dtype(out_dtype).itemsize
    out = np.zeros(out_base + out_bytes + 32, np.uint8)
    writes = np.zeros_like(out, dtype=np.int32)
    ppu, ppr, V = plan.pieces_per_unit, plan.pieces_per_row, 16 // tout
    magics = [P.fast_divisor(d) for d in (plan.row_len, plan.piece_len, ppr,
                                          plan.in_slot // 16, py, px)]

    def fdiv(which, num):
        assert 0 <= num < 2**31
        m, sh = magics[which]
        return (num * m >> 32) >> sh if m else num

    def cast(raw: np.ndarray) -> np.ndarray:
        if tin == tout == 1:
            return raw
        return raw.view(in_dtype).astype(out_dtype).view(np.uint8)

    def piece(q):
        row = fdiv(2, q)
        j0 = (q - row * ppr) * plan.piece_len
        plane = fdiv(4, row)
        r = row - plane * py
        p = fdiv(5, plane)
        i = plane - p * px
        x, y, z, s = windows[p]
        src = (src_base + s * subjects_bytes + ((x + i) * ye + y + r) * ze * c * es
               + z * c * es + j0 * tin)
        return src, row * plan.row_len + j0, min(plan.piece_len, plan.row_len - j0)

    granules = plan.in_slot // 16
    for b in range(plan.blocks):
        for u in range(b, plan.units, plan.blocks):
            first = u * ppu
            count = min(ppu, plan.pieces - first)
            assert count >= 1
            stage = np.full(ppu * plan.in_slot, 0xCD, np.uint8)
            phase = np.zeros(ppu, np.int64)
            for f in range(count * granules):
                k = fdiv(3, f)
                v = f - k * granules
                src, _, ln = piece(first + k)
                a = (src & ~15) + 16 * v
                if v == 0:
                    phase[k] = src & 15
                    assert (src & 15) + ln * tin <= plan.in_slot  # the span fits its slot
                if a < src + ln * tin:
                    assert src_base - 16 <= a and a + 16 <= len(mem)
                    stage[k * plan.in_slot + 16 * v:k * plan.in_slot + 16 * v + 16] = \
                        mem[a:a + 16]

            def locate(e):
                row = fdiv(0, e)
                col = e - row * plan.row_len
                j = fdiv(1, col)
                return (row * ppr + j - first, col - j * plan.piece_len,
                        min(plan.piece_len, plan.row_len - j * plan.piece_len))

            def at(k, off):
                return k * plan.in_slot + phase[k] + off * tin

            _, e0, _ = piece(first)
            _, e1, l1 = piece(first + count - 1)
            d, de = out_base + e0 * tout, out_base + (e1 + l1) * tout
            da = d & ~15
            for v in range((de - da + 15) // 16):
                lo = da + 16 * v
                full = lo >= d and lo + 16 <= de
                if full:
                    k, off, ln = locate((lo - out_base) // tout)
                    if off + V <= ln:
                        a = at(k, off)
                        # load_shifted's aligned vectors stay in the slot
                        assert (a & ~15) + 16 * -(-((a & 15) + V * tin) // 16) <= \
                            (k + 1) * plan.in_slot
                        out[lo:lo + 16] = cast(stage[a:a + V * tin])
                        writes[lo:lo + 16] += 1
                        continue
                for m in range(V):
                    bb = lo + m * tout
                    if bb < d or bb >= de:
                        continue
                    k, off, _ = locate((bb - out_base) // tout)
                    a = at(k, off)
                    out[bb:bb + tout] = cast(stage[a:a + tin])
                    writes[bb:bb + tout] += 1
    assert not writes[:out_base].any() and not writes[out_base + out_bytes:].any()
    return out[out_base:out_base + out_bytes], writes[out_base:out_base + out_bytes]


# (dtype in, dtype out, pz, C): output rows of 1, 3, 17, 96, 155 and 155 x 4
# bytes copied, and casts whose 16-byte output granules take 8 or 32 source bytes
_PLAN_CASES = {
    "row1": (np.uint8, np.uint8, 1, 1),
    "row3": (np.uint8, np.uint8, 1, 3),
    "row17": (np.uint8, np.uint8, 17, 1),
    "row96-f16": (np.float16, np.float16, 48, 1),
    "row155": (np.uint8, np.uint8, 155, 1),
    "row620": (np.uint8, np.uint8, 155, 4),
    "f16-to-f32": (np.float16, np.float32, 7, 3),
    "f32-to-f16": (np.float32, np.float16, 13, 1),
}


@pytest.mark.parametrize("stage", ["card", "small"])
@pytest.mark.parametrize("case", list(_PLAN_CASES))
def test_plan_gather_covers_every_output_byte_once(case, stage, monkeypatch):
    """Every byte of every store's output written exactly once from its
    source byte, on the card's plan (132 SMs) and on a small stage and piece
    (rows cut into pieces, planes into many units, blocks of many units;
    6 SMs), at source and output bases off every 16-byte phase tried."""
    if stage == "small":
        monkeypatch.setattr(P, "_STAGE_BYTES", 96)
        monkeypatch.setattr(P, "_PIECE_BYTES", 40)
    in_dtype, out_dtype, pz, c = _PLAN_CASES[case]
    rng = np.random.default_rng(len(case))
    shape = (2, 5, 4, pz + 3, c)
    store = (rng.integers(0, 256, size=shape).astype(np.uint8) if in_dtype == np.uint8
             else (rng.normal(size=shape) * 100).astype(in_dtype))
    patch = (3, 4, pz)
    corners = np.array([[0, 0, 0], [2, 0, 3], [1, 0, 1], [2, 0, 2]], np.int32)
    windows = np.concatenate([corners, [[1], [0], [1], [1]]], axis=1).astype(np.int32)
    es, eo = np.dtype(in_dtype).itemsize, np.dtype(out_dtype).itemsize
    copy = in_dtype == out_dtype
    label = np.zeros((2, 5, 4, pz + 3, 2), np.uint8)  # a second store shares the grid
    rows = [(pz * c * es, 1, 1) if copy else (pz * c, es, eo), (pz * 2, 1, 1)]
    sms = 132 if stage == "card" else 6
    plans, stage_bytes = P.plan_gather(len(windows), *patch[:2], rows, sms)
    assert stage_bytes % 16 == 0 and stage_bytes <= 20 * 1024
    assert stage_bytes <= max(P._STAGE_BYTES, max(p.in_slot + 16 for p in plans))
    for p in plans:
        assert p.pieces_per_unit * p.in_slot + p.pieces_per_unit <= stage_bytes
        assert (p.units - 1) * p.pieces_per_unit < p.pieces <= p.units * p.pieces_per_unit
    assert all(1 <= p.blocks <= p.units for p in plans)
    assert sum(p.blocks for p in plans) <= sms * P._BLOCKS_PER_SM
    want = torch.from_numpy(store.astype(np.float32) if in_dtype == np.float16 else store)
    ref = P.extract_patches_plain(want, corners, patch, subjects=windows[:, 3])
    ref = ref.numpy().astype(out_dtype)
    for ph_in, ph_out in ((0, 0), (3, 0), (5, 9), (15, 1)):
        phases = (ph_in - ph_in % es, ph_out - ph_out % eo)  # element-aligned bases
        got, writes = _emulate(store, windows, patch, plans[0], in_dtype, out_dtype, phases)
        assert (writes == 1).all()
        np.testing.assert_array_equal(got, ref.reshape(-1).view(np.uint8))
        got, writes = _emulate(label, windows, patch, plans[1], np.uint8, np.uint8,
                               (ph_in, ph_out))
        assert (writes == 1).all()


def test_plan_gather_splits_the_grid_by_bytes():
    """At the sampler's batch (32 windows of 96^3, bf16 images and uint8
    labels) the 396 blocks of 132 SMs go 2 : 1 to the images, and a unit of
    either store loads about a stage (20 KB) of source rows."""
    plans, stage_bytes = P.plan_gather(32, 96, 96, [(192, 1, 1), (96, 1, 1)], 132)
    assert [p.blocks for p in plans] == [264, 132]
    assert [p.in_slot for p in plans] == [208, 112]
    assert all(18 * 1024 < p.pieces_per_unit * p.in_slot <= 20 * 1024 for p in plans)
    assert stage_bytes <= 20 * 1024
    one, _ = P.plan_gather(8, 96, 96, [(96, 2, 2)], 132)
    assert one[0].blocks == 396 and one[0].pieces == 8 * 96 * 96


@pytest.mark.parametrize("d", [1, 2, 3, 7, 12, 96, 97, 155, 208, 4096, 65535, 2**20 + 1,
                               2**30, 2**31 - 1])
def test_fast_divisor_divides_every_int31(d):
    """The kernel's division by a multiply and a shift, exact for every
    numerator below 2^31: its edges, multiples of d and their neighbours,
    and random ones."""
    magic, shift = P.fast_divisor(d)
    assert 0 <= magic < 2**32
    rng = np.random.default_rng(d % 1000)
    k = np.arange(0, 2**31 // d + 1, max(1, (2**31 // d) // 5000), dtype=np.int64)
    nums = np.concatenate([np.arange(0, 4096), rng.integers(0, 2**31, 20000),
                           k * d, k * d - 1, k * d + 1, [2**31 - 1, 2**31 - 2]])
    nums = np.unique(nums[(nums >= 0) & (nums < 2**31)]).astype(object)
    got = np.array([(n * magic >> 32) >> shift if magic else n for n in nums])
    np.testing.assert_array_equal(got, nums // d)
