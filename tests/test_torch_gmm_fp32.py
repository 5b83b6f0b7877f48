"""``gmm``'s fp32 body selection (``gmm.fp32_tile`` / ``fp32_body``) and the
C interface of its tiled body, on the CPU: which calls the card would run
on the tiled body (``csrc/gmm_fp32.cuh``) and at which tile, and the body
code the C entry gets."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import gmm as gmm_mod  # noqa: E402

# granite-moe-3b-a800m: d_model 1536, d_expert 512 (w_in's 2F = 1024).
D, F2, FE = 1536, 1024, 512
# The dropless fragment's six tile calls at C rows: (name, C, K, N, layouts)
# as core/executor.py's _mm passes them (x, w; 1 = a transposed view).


def tile_calls(C):
    return [("gmm1", C, D, F2, (0, 0)), ("gmm2", C, FE, D, (0, 0)),
            ("gmm1_act_grad", C, F2, D, (0, 1)),
            ("gmm2_act_grad", C, D, FE, (0, 1)),
            ("gmm1_wgrad", D, C, F2, (1, 0)),
            ("gmm2_wgrad", FE, C, D, (1, 0))]


LAYOUTS = [(0, 0), (0, 1), (1, 0), (1, 1)]


def operands(E, C, K, N, layouts, dtype=torch.float32):
    """Uninitialised x [E, C, K] and w [E, K, N] in the given layouts (a
    transposed view of a contiguous tensor where 1)."""
    la, lb = layouts
    x = torch.empty((E, K, C) if la else (E, C, K), dtype=dtype)
    w = torch.empty((E, N, K) if lb else (E, K, N), dtype=dtype)
    return (x.transpose(1, 2) if la else x,
            w.transpose(1, 2) if lb else w)


def aligned(C, K, N, layouts):
    """Whether every contiguous dim of the call is a multiple of 4 floats:
    x's K (C if x is a transposed view), w's N (K if w is) and N."""
    la, lb = layouts
    return all(d % 4 == 0 for d in (C if la else K, K if lb else N, N))


@pytest.mark.parametrize("layouts", LAYOUTS)
@pytest.mark.parametrize("call", range(6))
@pytest.mark.parametrize("C", [683, 1001])
def test_dropless_tile_calls_take_the_tiled_body(C, call, layouts):
    """Each of the six tile calls at an expert's share of rows runs the
    tiled body in the layout the executor passes it, and in every other
    layout whose contiguous dims stay multiples of 4: the rows (683, 1001)
    read as a contiguous dim send a call to the small-row body."""
    _, c, K, N, own = tile_calls(C)[call]
    x, w = operands(1, c, K, N, layouts)
    want = "tiled" if aligned(c, K, N, layouts) else "small"
    assert aligned(c, K, N, own)
    assert gmm_mod.fp32_body(x, w) == want
    assert (gmm_mod.fp32_tile(x, w) in gmm_mod.FP32_TILES) == (
        want == "tiled")
    if layouts == own:
        assert want == "tiled"


# (E, C, K, N, layouts) -> tile code at 132 SMs (two CTAs per SM: 264
# slots): the largest of 64x128, 64x64, 32x64 with at least 264 CTAs, else
# 32x64.
TILE_RULE = [
    ((1, 683, D, F2, (0, 0)), 3),      # GMM1: 88, 176, 352 CTAs
    ((1, 683, FE, D, (0, 0)), 2),      # GMM2: 132, 264
    ((1, 683, F2, D, (0, 1)), 2),      # its activation gradient: 132, 264
    ((1, 683, D, FE, (0, 1)), 3),      # GMM2's: 44, 88, 176: the smallest
    ((1, D, 683, F2, (1, 0)), 2),      # GMM1's weight gradient: 192, 384
    ((1, FE, 683, D, (1, 0)), 3),      # GMM2's: 96, 192, 384
    ((1, 1001, D, F2, (0, 0)), 3),     # 128, 256, 512
    ((1, 1001, FE, D, (0, 0)), 2),     # 192, 384
    ((48, 854, FE, D, (0, 0)), 1),     # the fp32 fixed-capacity GMM2
]


@pytest.mark.parametrize("call,code", TILE_RULE)
def test_tile_rule_at_the_cards_sm_count(call, code):
    assert gmm_mod.fp32_tile(*operands(*call)) == code


@pytest.mark.parametrize("E,C,K,N,body", [
    (1, 8, D, F2, "small"),         # below FP32_TILED_MIN_ROWS
    (1, 8, FE, 160, "small"),
    (3, 1, 1536, 18, "small"),      # the CPU tests' ragged shapes
    (3, 2, 1536, 40, "small"),
    (3, 27, 1536, 160, "tiled"),    # N = 160: a multiple of 4, masked
    (3, 64, 96, 160, "tiled"),
    (1, 683, D, 18, "small"),       # N = 18: not a multiple of 4
    (1, 683, 1538, F2, "small"),    # K contiguous, not a multiple of 4
    (1, 9, D, F2, "tiled"),         # the threshold itself
])
def test_fp32_body_rule(E, C, K, N, body):
    assert gmm_mod.fp32_body(*operands(E, C, K, N, (0, 0))) == body


def test_unaligned_bases_and_bf16_take_the_fma_body():
    x, w = operands(1, 683, D, F2, (0, 0))
    assert gmm_mod.fp32_body(x, w) == "tiled"
    # The same shapes 4 bytes into their storage.
    x4 = torch.empty(683 * D + 1)[1:].view(1, 683, D)
    w4 = torch.empty(D * F2 + 1)[1:].view(1, D, F2)
    assert x4.data_ptr() % 16 and w4.data_ptr() % 16
    assert gmm_mod.fp32_body(x4, w) == "small"
    assert gmm_mod.fp32_body(x, w4) == "small"
    xb, wb = operands(1, 683, D, F2, (0, 0), torch.bfloat16)
    assert gmm_mod.fp32_body(xb, wb) == "none"
    assert gmm_mod.fp32_tile(xb, wb) == 0


def test_cpu_calls_leave_the_tiled_count_at_zero():
    """A CPU call at a shape the tiled body would take runs the plain
    version and counts no launch of either body."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 64, 32), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((1, 32, 64), dtype=np.float32))
    assert gmm_mod.fp32_body(x, w) == "tiled"
    before = (gmm_mod.launches, gmm_mod.launches_fp32_tiled,
              gmm_mod.launches_fp32_small)
    got = gmm_mod.gmm(x, w)
    assert torch.equal(got, torch.bmm(x, w))
    assert gmm_mod.fp32_body(x[:, :3], w) == "small"
    assert gmm_mod.gmm(x[:, :3], w).shape == (1, 3, 64)
    assert (gmm_mod.launches, gmm_mod.launches_fp32_tiled,
            gmm_mod.launches_fp32_small) == before == (0, 0, 0)


def test_gmm_c_entry_takes_the_body_code():
    """``gmm_launch`` has one more int than before the tiled body: the body
    code, after the two layout codes and before the dtype code."""
    src, entry, argtypes = build.KERNELS["gmm"]
    assert (src, entry) == ("gmm.cu", "gmm_launch")
    assert len(argtypes) == 12 and argtypes[9] is build.ctypes.c_int
    assert {"gmm_fp32.cuh", "gmm_fp32_small.cuh"} <= set(build.HEADERS)
    x, w, y = torch.zeros(2, 3, 8), torch.zeros(2, 8, 4), torch.zeros(2, 3, 4)
    args = build.c_args("gmm", (x, w, y, 2, 3, 8, 4, 0, 1, 3),
                        torch.float32)
    assert args[:3] == [t.data_ptr() for t in (x, w, y)]
    assert args[3:] == [2, 3, 8, 4, 0, 1, 3, 0]
    with pytest.raises(TypeError):       # without the body code
        build.c_args("gmm", (x, w, y, 2, 3, 8, 4, 0, 1), torch.float32)


def test_c_entry_knows_every_tile_code():
    """Each ``FP32_TILES`` code is a case of the C entry's tile switch with
    the same tile, and the switch has no other."""
    text = (build.CSRC / "gmm_fp32.cuh").read_text()
    cases = {int(c): (int(bm), int(bn)) for c, bm, bn in re.findall(
        r"GMMF_TILE\((\d+), (\d+), (\d+), \d+, \d+\)", text)}
    assert cases == gmm_mod.FP32_TILES
