"""The bf16 walk of csrc/sdf_mlp_wgmma.cuh, held on the CPU where it differs
from the 3xTF32 one.

No CUDA runs here, so the pieces the kernel relies on are checked against the
packer and modelled in numpy, with the constants and the lines the models
follow read from the source:

- The model's head (scale, clamp, frequencies, biases, output layer: every
  float before the tiles) is copied to shared memory beside the pinned tiles
  by one bulk copy of `Shape.head` bytes: it is exactly what `_pack_wg16`
  writes before the tiles, a multiple of 16 bytes, and every sequence of a
  batched pack starts 16-byte aligned.
- `plan()` pins tiles beside the head: every tile of the shipped net for #3,
  #4, #6; the depth-8 net streams 11 of its 58 tiles.
- The output layer rounds its activations two to a `cvt.rn.bf16x2`, taking
  each out of the packed word: the same bits as rounding each alone.
- A pinned layer issues its eight products on descriptors stepped from its
  first tile's: the descriptors of the tiles themselves.

The kernels themselves are held on the card (`chip_smoke.py` phase 14c, the
`gpu` tests).
"""

import re

import numpy as np
import pytest
import torch

from hotrack_tpu_torch.ops import kernels, sdf_mlp
from hotrack_tpu_torch.utils.convert import distilled_from_numpy
from torch_sdf_models import model_arrays

HEADER = (kernels.CSRC_DIR / "sdf_mlp_wgmma.cuh").read_text()
SMEM_LIMIT = 232_448   # an H100 block's opt-in shared memory (227 KB)


def _constant(name: str) -> int:
    return int(re.search(rf"^constexpr (?:int|uint32_t) {name} = (\d+);", HEADER, re.M).group(1))


UNITS, RING, TILE_BYTES = _constant("kUnits"), _constant("kRing"), 8 * _constant("kUnits") * 4


def _head_floats(n_freqs: int, n_hidden: int) -> int:
    """tiles_offset(): the header (4 + the frequencies padded to 4), the
    biases (128 a hidden layer), the output layer (128 weights, its bias, 3
    zeros)."""
    return 4 + -(-n_freqs // 4) * 4 + UNITS * n_hidden + UNITS + 4


def _tiles16(n_freqs: int, n_hidden: int) -> tuple:
    """make_shape's bf16 (first_tiles, tiles)."""
    ks0 = (3 * n_freqs + 10) // 8
    return ks0, ks0 + 8 * (n_hidden - 1)


NETS = [((21, 128, 128, 128), None), ((9, 128), None), ((39, 128, 128, 128, 128), None),
        ((21,) + (128,) * 8, None), ((123, 128, 64), None), ((15, 32, 48), [1.0, 2.5])]


def test_the_source_keeps_the_head_beside_the_tiles():
    for line in ("return 4 + round_up4(s.n_freqs);",
                 "return header_floats(s) + kUnits * s.n_hidden + kUnits + 4;",
                 "s.head = 4 * tiles_offset(s);",
                 "limit -= s.head;",
                 "smem = smem_bytes(pinned, ring) + shape.head + extra;",
                 "float* head = reinterpret_cast<float*>(smem + smem_bytes(pinned, ring));",
                 "const int head_bytes = kBf16 ? shape.head : 0;",
                 "unsigned char* job_smem = smem + smem_bytes(pinned, ring) + head_bytes;",
                 "mbar_expect_tx(pin, static_cast<uint32_t>(pinned) * kTileBytes + head_bytes);",
                 "bulk_copy(smem_addr(head), packed + s * packed_seq, head_bytes, pin);",
                 "if constexpr (kBf16) net = net_in(head, shape);   // once the copy has landed"):
        assert line in HEADER, line
    # only the bf16 branch of make_shape sets a head: 3xTF32 reads its model from device memory
    start = HEADER.index("inline Shape make_shape(")
    shape = HEADER[start:HEADER.index("\n}\n", start)]
    assert shape.count("s.head =") == 1
    assert shape.index("s.head =") < shape.index("} else {")


@pytest.mark.parametrize("widths,freqs", NETS, ids=[f"{w[0]}x{len(w) - 1}" for w, _ in NETS])
def test_the_head_is_what_the_packer_writes_before_the_tiles(widths, freqs):
    arrays = model_arrays(3, widths=widths, freqs=freqs)
    model = distilled_from_numpy(arrays)
    n_freqs, n_hidden = (widths[0] - 3) // 6, len(widths) - 1
    buf = sdf_mlp.pack_distilled(model).wg16.numpy()
    head = _head_floats(n_freqs, n_hidden)
    assert 4 * head % 16 == 0
    assert buf.size - head == _tiles16(n_freqs, n_hidden)[1] * TILE_BYTES // 4
    assert buf[0] == arrays["scale"] and buf[1] == arrays["clamp"]
    np.testing.assert_array_equal(buf[4:4 + n_freqs], arrays["freqs"])
    at = 4 + -(-n_freqs // 4) * 4
    for l in range(n_hidden):
        b = arrays["biases"][l]
        np.testing.assert_array_equal(buf[at + UNITS * l:at + UNITS * l + b.size], b)
    out = at + UNITS * n_hidden
    w_out = torch.from_numpy(arrays["weights"][-1][:, 0]).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(buf[out:out + w_out.size], w_out)
    assert buf[out + UNITS] == arrays["biases"][-1][0]
    # a batched pack's sequences start 16-byte aligned: the bulk copy's source
    models = [distilled_from_numpy(model_arrays(s, widths=widths, freqs=freqs)) for s in range(3)]
    assert sdf_mlp.pack_distilled_batched(models).wg16.shape[-1] % 4 == 0


def _plan(tiles: int, first_tiles: int, head: int, extra: int) -> tuple:
    """wg::plan within SMEM_LIMIT - extra bytes and the head: (pinned, ring)."""
    barrier = lambda ring: (8 * (2 * ring + 1) + 15) & ~15   # noqa: E731
    limit = SMEM_LIMIT - extra - head
    if tiles * TILE_BYTES + barrier(0) <= limit:
        return tiles, 0
    fit = (limit - RING * TILE_BYTES - barrier(RING)) // TILE_BYTES
    return (fit if fit >= first_tiles else -1), RING


# (kernel, widths, the job's bytes, pinned, streamed)
PLANS = [("#3, #6", (21, 128, 128, 128), 0, 18, 0), ("#4", (21, 128, 128, 128), 64, 18, 0),
         ("#3 depth 8", (21,) + (128,) * 8, 0, 47, 11),
         ("#4 depth 8", (21,) + (128,) * 8, 64, 47, 11)]


@pytest.mark.parametrize("kernel,widths,extra,pinned,streamed", PLANS,
                         ids=[p[0] for p in PLANS])
def test_the_plan_pins_tiles_beside_the_head(kernel, widths, extra, pinned, streamed):
    n_freqs, n_hidden = (widths[0] - 3) // 6, len(widths) - 1
    first, tiles = _tiles16(n_freqs, n_hidden)
    got = _plan(tiles, first, 4 * _head_floats(n_freqs, n_hidden), extra)
    assert got == (pinned, RING if streamed else 0) and tiles - pinned == streamed, got


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 to nearest, ties to even, as its 16 bits."""
    return torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def test_paired_conversions_round_as_one_each():
    for line in ('asm("cvt.rn.bf16x2.f32 %0, %1, %2;\\n" : "=r"(d) : "f"(hi), "f"(lo));',
                 "return __uint_as_float(v << 16); }",
                 "return __uint_as_float(v & 0xFFFF0000u); }",
                 "p0 = fmaf(bf16_lo(r0), wo.x, p0);", "p0 = fmaf(bf16_hi(r0), wo.y, p0);",
                 "p1 = fmaf(bf16_lo(r1), wo.x, p1);", "p1 = fmaf(bf16_hi(r1), wo.y, p1);"):
        assert line in HEADER, line
    rng = np.random.RandomState(7)
    x = (rng.randn(4096) * 10.0 ** rng.randint(-6, 4, 4096)).astype(np.float32)
    # exact ties: a bf16 value and half of its last place
    b = (_bf16_bits(x[:1024]).astype(np.uint32) << 16).view(np.float32)
    ties = b + np.sign(b) * np.float32(2.0) ** (np.floor(np.log2(np.abs(b))) - 8)
    x = np.concatenate([x, ties, [0.0, -0.0, 1e-40, -1e-40, 65504.0, 3.0e38]]).astype(np.float32)
    lo, hi = x[0::2], x[1::2]
    word = _bf16_bits(lo).astype(np.uint32) | (_bf16_bits(hi).astype(np.uint32) << 16)
    one = lambda v: (_bf16_bits(v).astype(np.uint32) << 16).view(np.float32)   # noqa: E731
    np.testing.assert_array_equal((word << 16).astype(np.uint32).view(np.float32), one(lo))
    np.testing.assert_array_equal((word & 0xFFFF0000).astype(np.uint32).view(np.float32), one(hi))


def _tile_desc(addr: int) -> int:
    """tile_desc(): the start address's bits 4-17, then the leading and the
    stride byte offsets (16-byte units) at bits 16 and 32."""
    lbo, sbo = _constant("kLbo"), _constant("kSbo")
    return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32)


@pytest.mark.parametrize("first_tile", [0, 2, 10, 47, 48])
def test_a_layers_descriptors_step_by_a_tile(first_tile):
    """A pinned layer's eight products take the descriptor of its first tile
    plus kTileBytes / 16 a k-step: the descriptors of the tiles themselves,
    for every first tile a block can pin (its shared memory is under 256 KB)."""
    for line in ("const uint64_t desc = tile_desc(w.pinned_base + "
                 "static_cast<uint32_t>(first_tile) * kTileBytes);",
                 "wgmma_bf16(d, a[ks], desc + static_cast<uint64_t>(ks) * (kTileBytes >> 4), "
                 "ks > 0);",
                 "if (first_tile + kMaxKSteps / 2 <= w.pinned) {"):
        assert line in HEADER, line
    base = 0   # the pinned tiles start the block's dynamic shared memory
    assert (first_tile + 8) * TILE_BYTES <= SMEM_LIMIT
    first = _tile_desc(base + first_tile * TILE_BYTES)
    for ks in range(8):
        assert first + ks * (TILE_BYTES >> 4) == _tile_desc(base + (first_tile + ks) * TILE_BYTES)
