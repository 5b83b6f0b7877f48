"""``gmm``'s fp32 body selection (``gmm.fp32_tile`` / ``fp32_body``) and the
C interface of its tiled and narrow bodies, on the CPU: which calls the
card would run on the tiled body (``csrc/gmm_fp32.cuh``) and at which tile,
which on the narrow body (``csrc/gmm_fp32_narrow.cuh``) and at which
configuration, which on the small-row body, and the body code the C entry
gets."""

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


ROWS = [1, 2, 8, 9, 17, 32, 64, 127, 128, 683]


def tma_describes(K, N, layouts):
    """The narrow body's tensor maps take the call: x contiguous with K a
    multiple of 4 floats, w's contiguous dim (N, or K if transposed) too."""
    la, lb = layouts
    return la == 0 and K > 0 and K % 4 == 0 and (K if lb else N) % 4 == 0


@pytest.mark.parametrize("layouts", LAYOUTS)
@pytest.mark.parametrize("call", range(6))
@pytest.mark.parametrize("C", ROWS)
def test_tile_calls_body_and_grid_by_rows(C, call, layouts):
    """Each of the six tile calls at a tile of C rows, in every layout: the
    tiled body where it takes the call by size and its widths are multiples
    of 4, the narrow body for smaller calls where TMA describes them, else
    the small-row body. A narrow call's configuration is the
    rule's: the first of ``NARROW_BY_ROWS`` whose row bound takes them;
    its grid covers the call once. In the executor's own
    layouts every call too small for the tiled body runs the narrow body.
    """
    name, c, K, N, own = tile_calls(C)[call]
    x, w = operands(1, c, K, N, layouts)
    # A transposed view of one row (or one column) is also contiguous:
    # the rule reads the layout code the view has.
    eff = gmm_mod.operand_layout(x, "x"), gmm_mod.operand_layout(w, "w")
    assert eff == layouts or 1 in (c, K)
    if tiled_by_size(1, c, N):
        want = "tiled" if aligned(c, K, N, eff) else "small"
    else:
        want = "narrow" if tma_describes(K, N, eff) else "small"
    assert gmm_mod.fp32_body(x, w) == want
    code = gmm_mod.fp32_tile(x, w)
    assert (code in gmm_mod.FP32_NARROW) == (want == "narrow")
    if want == "narrow":
        assert code == next(k for most, k in gmm_mod.NARROW_BY_ROWS
                            if most is None or c <= most)
        tm, tn, warps, cl = gmm_mod.FP32_NARROW[code]
        rb, bn = 32 // cl * tm * warps, cl * tn
        assert rb == gmm_mod.narrow_rows(code) and bn in (8, 16)
        assert bn == gmm_mod.narrow_cols(code)
        assert 0 <= -(-c // rb) * rb - c < rb and -(-N // bn) * bn >= N
    if layouts == own and not tiled_by_size(1, c, N):
        assert want == "narrow"


# (tile call, C) -> (narrow code, CTAs): every CTA 8 columns wide, so GMM1
# (N 1024) runs 128 column blocks, GMM2 and GMM1's activation gradient
# (N 1536) 192, GMM2's activation gradient (N 512) 64; rows by 4, 8, 32 or
# 64 a CTA.
NARROW_GRID = [
    (0, 1, 4, 128), (0, 2, 4, 128), (0, 4, 4, 128), (0, 5, 5, 128),
    (0, 8, 5, 128), (0, 9, 5, 256), (0, 16, 5, 256), (0, 17, 6, 128),
    (0, 32, 6, 128), (0, 33, 7, 128), (0, 64, 7, 128), (0, 127, 7, 256),
    (1, 1, 4, 192), (1, 8, 5, 192), (1, 17, 6, 192), (1, 64, 7, 192),
    (2, 1, 4, 192), (2, 32, 6, 192), (2, 33, 7, 192),
    (3, 1, 4, 64), (3, 16, 5, 128), (3, 127, 7, 128), (3, 256, 7, 256),
]


@pytest.mark.parametrize("call,C,code,ctas", NARROW_GRID)
def test_narrow_grid_fills_the_card(call, C, code, ctas):
    """The narrow body's configuration and grid at the decode and prefill
    tiles' rows: at C = 1 GMM1 runs 128 CTAs and GMM2 192 on the card's
    132 SMs, where the small-row body ran 32 and 48."""
    _, c, K, N, layouts = tile_calls(C)[call]
    x, w = operands(1, c, K, N, layouts)
    assert not tiled_by_size(1, C, N) and gmm_mod.fp32_tile(x, w) == code
    rows, cols = gmm_mod.narrow_rows(code), gmm_mod.narrow_cols(code)
    assert -(-C // rows) * -(-N // cols) == ctas


@pytest.mark.parametrize("C", [1, 2, 8, 9, 17, 32, 64, 127])
@pytest.mark.parametrize("offset", [(4, 0), (0, 4), (8, 8)])
def test_unaligned_bases_under_the_threshold_take_the_small_body(C, offset):
    """Under the threshold a base that is not 16-byte aligned sends a call
    that TMA would otherwise take to the small-row body, by name."""
    ox, ow = offset
    x = torch.empty(C * D + 4)[ox // 4:ox // 4 + C * D].view(1, C, D)
    w = torch.empty(D * F2 + 4)[ow // 4:ow // 4 + D * F2].view(1, D, F2)
    assert gmm_mod.fp32_body(x, w) == "small"
    assert gmm_mod.fp32_tile(x, w) == 0


@pytest.mark.parametrize("C", [1, 8, 17, 127])
@pytest.mark.parametrize("K,N,lb,want", [
    (D, 18, 0, "small"),            # w [K][N] with N = 18: no tensor map
    (D, 18, 1, "narrow"),           # w stored [N][K]: K is the row, N free
    (D, 1002, 0, "small"),
    (1538, F2, 0, "small"),         # K = 1538 read contiguous
    (1538, F2, 1, "small"),
    (36, 40, 0, "narrow"),          # one full slab and a partial one
    (4, 24, 1, "narrow"),           # a partial slab alone
])
def test_ragged_widths_under_the_threshold(C, K, N, lb, want):
    x, w = operands(3, C, K, N, (0, lb))
    assert gmm_mod.fp32_body(x, w) == want


def test_narrow_usable_follows_the_layouts():
    """``narrow_usable`` takes the layout codes, not the views: x passed as
    a transposed view is refused whatever its widths."""
    x, w = operands(1, 8, D, F2, (0, 0))
    assert gmm_mod.narrow_usable(x, w, 0, 0)
    assert not gmm_mod.narrow_usable(x, w, 1, 0)
    xt, wt = operands(1, 8, D, F2, (1, 1))
    assert gmm_mod.fp32_body(xt, wt) == "small"


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


def tiled_by_size(E, C, N):
    """The tiled body's share by size: from 257 rows, or once its 32 x 64
    tile's grid reaches 72 CTAs (half an H100's SMs and a little more)."""
    return C >= 257 or E * -(-C // 32) * -(-N // 64) >= 72


def test_size_rule_constants():
    assert (gmm_mod.FP32_TILED_MIN_ROWS, gmm_mod.FP32_TILED_MIN_CTAS) == (
        257, 72)
    assert gmm_mod.FP32_TILES[max(gmm_mod.FP32_TILES)] == (32, 64)


@pytest.mark.parametrize("E,C,K,N,body", [
    (1, 8, D, F2, "narrow"),        # a decode tile
    (1, 8, FE, 160, "narrow"),
    (3, 1, 1536, 18, "small"),      # the CPU tests' ragged shapes: N = 18
    (3, 2, 1536, 40, "narrow"),     # N = 40: a multiple of 4
    (3, 27, 1536, 160, "narrow"),   # N = 160: a multiple of 4, masked
    (3, 64, 96, 160, "narrow"),
    (1, 683, D, 18, "small"),       # N = 18: not a multiple of 4
    (1, 683, 1538, F2, "small"),    # K contiguous, not a multiple of 4
    (1, 9, D, F2, "narrow"),        # the old threshold
    (1, 128, D, F2, "narrow"),      # GMM1: 4 x 16 = 64 tiled CTAs
    (1, 129, D, F2, "tiled"),       # 5 x 16 = 80
    (1, 64, FE, D, "narrow"),       # GMM2: 2 x 24 = 48
    (1, 65, FE, D, "tiled"),        # 3 x 24 = 72
    (1, 256, D, FE, "narrow"),      # N = 512: 8 x 8 = 64
    (1, 257, D, FE, "tiled"),       # FP32_TILED_MIN_ROWS
    (48, 1, FE, D, "tiled"),        # 48 experts: 1,152 tiled CTAs
    (3, 257, 1536, 160, "tiled"),
    (1, 5, 1538, F2, "small"),      # narrow range, K not a multiple of 4
    (1, 5, 0, F2, "small"),         # K = 0: no tensor map
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
    version and counts no launch of any body; so does one at a shape the
    narrow body or the small-row body would take."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 257, 32), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((1, 32, 64), dtype=np.float32))
    assert gmm_mod.fp32_body(x, w) == "tiled"
    counts = ("launches", "launches_fp32_tiled", "launches_fp32_narrow",
              "launches_fp32_small")
    before = tuple(getattr(gmm_mod, c) for c in counts)
    got = gmm_mod.gmm(x, w)
    assert torch.equal(got, torch.bmm(x, w))
    assert gmm_mod.fp32_body(x[:, :3], w) == "narrow"
    assert gmm_mod.gmm(x[:, :3], w).shape == (1, 3, 64)
    w18 = w[:, :, :18].contiguous()
    assert gmm_mod.fp32_body(x[:, :3], w18) == "small"
    assert gmm_mod.gmm(x[:, :3], w18).shape == (1, 3, 18)
    assert tuple(getattr(gmm_mod, c) for c in counts) == before == (0,) * 4


def test_gmm_c_entry_takes_the_body_code():
    """``gmm_launch`` has one more int than before the tiled body: the body
    code, after the two layout codes and before the dtype code."""
    src, entry, argtypes = build.KERNELS["gmm"]
    assert (src, entry) == ("gmm.cu", "gmm_launch")
    assert len(argtypes) == 12 and argtypes[9] is build.ctypes.c_int
    assert {"gmm_fp32.cuh", "gmm_fp32_narrow.cuh",
            "gmm_fp32_small.cuh"} <= set(build.HEADERS)
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


def test_c_entry_knows_every_narrow_code():
    """Each ``FP32_NARROW`` code is a case of the narrow body's switch with
    the same (TM, TN, W, CL), the switch has no other, and the codes follow the
    tiled body's, so that one int names the body and its shape."""
    text = (build.CSRC / "gmm_fp32_narrow.cuh").read_text()
    cases = {int(c): tuple(int(v) for v in vs) for c, *vs in re.findall(
        r"GMMN_CFG\((\d+), (\d+), (\d+), (\d+), (\d+)\)", text)}
    assert cases == gmm_mod.FP32_NARROW
    assert min(gmm_mod.FP32_NARROW) > max(gmm_mod.FP32_TILES)
    assert [code for _, code in gmm_mod.NARROW_BY_ROWS] == sorted(
        gmm_mod.FP32_NARROW)


def test_c_entry_sends_narrow_codes_to_the_narrow_body():
    """``gmm_launch`` hands every code from the narrow body's first on to
    ``gmmn::launch`` (fp32 only) before the tiled body's test, and
    ``c_args`` passes such a code through as the body int."""
    text = (build.CSRC / "gmm.cu").read_text()
    first = min(gmm_mod.FP32_NARROW)
    at = text.index(f"if (body >= {first})")
    assert text.index("gmmn::launch", at) < text.index("gmmf::launch", at)
    assert '#include "gmm_fp32_narrow.cuh"' in text
    x, w, y = torch.zeros(1, 3, 8), torch.zeros(1, 8, 4), torch.zeros(1, 3, 4)
    for code in gmm_mod.FP32_NARROW:
        args = build.c_args("gmm", (x, w, y, 1, 3, 8, 4, 0, 0, code),
                            torch.float32)
        assert args[9] == code and args[10] == 0
