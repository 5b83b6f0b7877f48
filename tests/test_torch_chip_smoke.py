"""Helpers of ``chip_smoke.py`` that run without a card: the precision
control of the trainable expert FFN's end-to-end check, the reader of the
compiler's register and spill report, the dropless tiles' body check,
phase 9's SSC lookups check and the cases of phases 10-12, 14-19b and
20-21."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("bits", [1, 2, 3])
def test_round_off_rounds_to_fewer_mantissa_bits(bits):
    """``round_off`` keeps 8 - bits significant bits of each bf16 value,
    rounding to nearest with ties away from zero, and clears the rest."""
    rng = np.random.default_rng(bits)
    v = (rng.standard_normal(4096) * 10.0 ** rng.integers(-3, 4, 4096))
    t = torch.from_numpy(v).to(torch.bfloat16)
    got = chip_smoke.round_off(t, bits)
    a = t.double().numpy()
    m, e = np.frexp(np.abs(a))
    q = 2.0 ** (8 - bits)
    want = np.sign(a) * np.ldexp(np.floor(m * q + 0.5) / q, e)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.double().numpy(), want)
    low = got.float().view(torch.int32) & ((1 << (16 + bits)) - 1)
    assert int(low.abs().max()) == 0
    # Each value moves by at most half of its coarser ulp.
    assert np.all(np.abs(want - a) <= np.abs(a) * 2.0 ** (bits - 8))


def test_ptxas_report_reads_each_tensor_core_kernel():
    """The build phase's reading of a ``-Xptxas -v`` log: one entry per
    ``gmmtc::gmm_tc_kernel`` instance with its template arguments,
    registers, static shared memory and spills; other kernels skipped."""
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN4gmmk11gmm_kernelIfLb0EEEvPKT_S3_PS1_iiiiiii' for 'sm_90a'",
        "ptxas info    : Used 40 registers, 2048 bytes smem",
        "ptxas info    : Compiling entry function "
        "'_ZN5gmmtc13gmm_tc_kernelILi2ELi4ELi1ELi0ELb0EEEv14CUtensorMap_st"
        "S1_S1_P13__nv_bfloat16iiiiiii' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN5gmmtc13gmm_tc_kernel",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 165 registers, used 1 barriers, 560 bytes "
        "cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_ZN5gmmtc13gmm_tc_kernelILi1ELi2ELi0ELi0ELb1EEEv14CUtensorMap_st"
        "S1_S1_P13__nv_bfloat16iiiiiii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 96 registers, 128 bytes smem, 560 bytes "
        "cmem[0]",
    ])
    assert chip_smoke.ptxas_report(log) == [
        {"kernel": "gmmtc::gmm_tc_kernel", "nwg": 2, "nb": 4, "ta": 1,
         "tb": 0, "swiglu": False, "spill_stores": 8, "spill_loads": 4,
         "registers": 165, "static_smem": 0},
        {"kernel": "gmmtc::gmm_tc_kernel", "nwg": 1, "nb": 2, "ta": 0,
         "tb": 0, "swiglu": True, "spill_stores": 0, "spill_loads": 0,
         "registers": 96, "static_smem": 128},
    ]


def test_ptxas_report_reads_each_backward_tensor_core_kernel():
    """``gsbtc::bwd_kernel`` instances are read with their mode (gu, dx,
    dw) and output type; the FMA body's kernels are skipped."""
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN3gsb9gu_kernelI13__nv_bfloat16EEvPKT_S4_S4_Pfiii' for "
        "'sm_90a'",
        "ptxas info    : Used 64 registers, 8704 bytes smem",
        "ptxas info    : Compiling entry function "
        "'_ZN5gsbtc10bwd_kernelILi2ELb1EEEvNS_4MapsEPK13__nv_bfloat16Pfiiii"
        "iii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 120 registers, used 3 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN5gsbtc10bwd_kernelILi0ELb0EEEvNS_4MapsEPK13__nv_bfloat16Pfiiii"
        "iii' for 'sm_90a'",
        "    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 168 registers, used 3 barriers",
    ])
    assert chip_smoke.ptxas_report(log) == [
        {"kernel": "gsbtc::bwd_kernel", "mode": "dw", "fp32_out": True,
         "spill_stores": 0, "spill_loads": 0, "registers": 120,
         "static_smem": 0},
        {"kernel": "gsbtc::bwd_kernel", "mode": "gu", "fp32_out": False,
         "spill_stores": 4, "spill_loads": 4, "registers": 168,
         "static_smem": 0},
    ]


def test_ptxas_report_reads_each_fp32_tiled_instance():
    """``gmmf::tiled_kernel`` instances are read with their tile, the
    thread's sums and the two layouts."""
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN4gmmf12tiled_kernelILi64ELi128ELi8ELi8ELi0ELi1EEEvPKfS2_Pfiii' "
        "for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 228 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN4gmmk10gmm_kernelIfLi8ELi16ELb0EEEvPKT_S3_PS1_iiiimmmmb' for "
        "'sm_90a'",
        "ptxas info    : Used 64 registers, 32768 bytes smem",
    ])
    assert chip_smoke.ptxas_report(log) == [
        {"kernel": "gmmf::tiled_kernel", "bm": 64, "bn": 128, "tm": 8,
         "tn": 8, "ta": 0, "tb": 1, "spill_stores": 0, "spill_loads": 0,
         "registers": 228, "static_smem": 0}]


def test_ptxas_report_reads_each_fp32_narrow_instance():
    """``gmmn::narrow_kernel`` instances are read with the thread's rows
    and columns and w's layout."""
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN4gmmn13narrow_kernelILi4ELi2ELi1EEEv14CUtensorMap_stS1_Pfiiiii'"
        " for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 149 registers, used 1 barriers",
    ])
    assert chip_smoke.ptxas_report(log) == [
        {"kernel": "gmmn::narrow_kernel", "tm": 4, "tn": 2, "tb": 1,
         "spill_stores": 0, "spill_loads": 0, "registers": 149,
         "static_smem": 0}]


def test_ptxas_report_reads_each_fp32_small_row_instance():
    """``gmms::small_kernel`` instances are read with their rows per CTA,
    the two layouts and whether w is copied in 16-byte chunks."""
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN4gmms12small_kernelILi4ELi0ELi0ELb1EEEvPKfS2_Pfiii' for "
        "'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 90 registers, used 1 barriers, 41472 bytes "
        "smem",
    ])
    assert chip_smoke.ptxas_report(log) == [
        {"kernel": "gmms::small_kernel", "rb": 4, "ta": 0, "tb": 0,
         "w16": True, "spill_stores": 0, "spill_loads": 0,
         "registers": 90, "static_smem": 41472}]


def _tile_row(rows, body, launched, shape="dropless_tile", N=1024, K=1536):
    row = {"kernel": "gmm", "C": rows, "K": K, "N": N, "body": body,
           "tiled_launches": launched if body != "narrow" else 0,
           "narrow_launches": launched if body == "narrow" else 0,
           "shape": shape}
    if shape == "dropless_tile":
        row["rows"] = rows
    return row


def test_first_tiled_rows_follow_the_tiled_bodys_grid():
    """The tiled body takes a one-expert call once its 32 x 64 tile's grid
    reaches 72 CTAs: 65 rows at N = 1536, 129 at 1024, and at 512 columns
    the row cap, 257."""
    assert [chip_smoke.first_tiled(1, n) for n in (1536, 1024, 512)] == [
        65, 129, 257]
    assert chip_smoke.first_tiled(48, 1536) == 1


def test_dropless_body_check_counts_the_tiled_rows():
    wgrad_of_one_row = dict(_tile_row(1, "small", 0), C=1536, K=1)
    wgrad_of_fifteen = dict(_tile_row(15, "tiled", 1), C=1536, K=15)
    rows = [_tile_row(683, "tiled", 1), _tile_row(1, "narrow", 1),
            wgrad_of_one_row, wgrad_of_fifteen, _tile_row(15, "narrow", 1),
            _tile_row(64, "narrow", 1, N=1536),
            _tile_row(65, "tiled", 1, N=1536),
            _tile_row(129, "small", 0, shape="dropless_edge"),
            _tile_row(5, "small", 0, shape="dropless_edge")]
    assert chip_smoke.check_fp32_bodies(rows) == {"tiled": 3, "narrow": 3}


@pytest.mark.parametrize("bad", [
    _tile_row(683, "small", 0),             # a tile call the rule sends on
    dict(_tile_row(683, "small", 0), C=1536, K=683),   # its weight gradient
    _tile_row(129, "small", 0),             # where the tiled body takes over
    _tile_row(129, "narrow", 1),            # ... on the narrow body
    _tile_row(65, "narrow", 1, N=1536),     # ... at N = 1536
    _tile_row(683, "tiled", 0),           # named, but not launched
    _tile_row(1, "small", 1, shape="dropless_edge"),   # launched, not named
    _tile_row(1, "small", 0),               # under it, TMA's: not narrow
    _tile_row(15, "tiled", 1),              # under it on the tiled body
    dict(_tile_row(8, "narrow", 1), narrow_launches=0),   # named only
    dict(_tile_row(5, "small", 0, shape="dropless_edge"),
         narrow_launches=1),                # launched, not named
])
def test_dropless_body_check_fails_on_a_wrong_body(bad):
    rows = [_tile_row(683, "tiled", 1), bad]
    with pytest.raises(AssertionError, match="wrong body"):
        chip_smoke.check_fp32_bodies(rows)


def test_fused_pp_and_elastic_phases_run_on_the_cpu():
    """Phases 10-12's cases at the smoke config's widths on the CPU,
    where ``gmm`` runs its plain version: the fused block equals its
    sequential twin bit for bit and the plain executor, the PP-fused
    taskflow equals its cells run one by one, and the rescaled handle and
    the remapped plan equal their native ep-rank runs. Without a card the
    fused block and its benchmark refuse to run unless asked for the CPU.
    """
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.ssc import SSCCache
    from repro_torch.launch import bench_fused_dropless
    from repro_torch.launch.dropless import DroplessConfig, FusedDroplessMoE
    cfg = get_smoke_config("granite-moe-3b-a800m")
    out = chip_smoke.run_fused_dropless(
        ["--device", "cpu", "--smoke", "--tokens", "48"])
    assert [r["ep"] for r in out["rows"]] == [1, 2]
    for r in out["rows"]:
        assert r["checks"]["bit_equal_sequential"]
        assert r["checks"]["fragments"]["fused"] == [2]
    pp = chip_smoke.pp_fused_case(cfg, tokens=32, ep=2, dev="cpu")
    for direction in ("forward", "backward"):
        assert pp[direction]["bit_equal_cells"]
        assert pp[direction]["fragments"] == 4
        assert pp[direction]["stage_boundary_tiles"] > 0
    el = chip_smoke.elastic_case(cfg, tokens=48, ep=3, dead=(1,),
                                 dev="cpu")
    assert el["survivors"] == [0, 2] and el["remap"]["ok"]
    assert el["cache"]["active_ep"] == 2 and el["cache"]["rekeyed"] == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FusedDroplessMoE(DroplessConfig(), cache=SSCCache())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench_fused_dropless.main(["--smoke", "--tokens", "48"])


def test_dropless_lookups_check_counts_one_fragment_forward_per_layer():
    """Phase 9's check on the smoke config with remat, two layers, two
    steps of fresh tokens and exact plans: the dropless impl runs each
    fragment's forward once (2 x 2 lookups a step, all misses) and passes;
    the same impl under a whole-block checkpoint re-runs every forward in
    the backward (one hit more a layer) and the check raises."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.ssc import SSCCache
    from repro_torch.launch import dropless, steps
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                              dtype="float32", remat=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    gen = torch.Generator().manual_seed(1)
    batches = [{k: torch.randint(0, cfg.vocab, (2, 16), generator=gen)
                for k in ("tokens", "labels")} for _ in range(2)]
    for whole_block in (False, True):
        dm = dropless.make_moe_dropless(
            cfg, dropless.DroplessConfig(ep=2, bucket=1), cache=SSCCache())
        impl = ((lambda p, h, mc: dm.impl(p, h, mc)) if whole_block
                else dm.impl)
        log = []
        for b in batches:
            steps.value_and_grad(cfg, params, b, moe_impl=impl)
            log.append({f"ssc_{k}": v for k, v in dm.step_stats().items()})
        if whole_block:
            assert [m["ssc_hits"] for m in log] == [2, 2]
            with pytest.raises(AssertionError, match="no hit"):
                chip_smoke.check_dropless_lookups(log, cfg.n_layers)
        else:
            assert chip_smoke.check_dropless_lookups(log, 2) == [4, 4]


def test_ep_phase_runs_on_the_cpu():
    """Phase 14's cases (b), (d) and (e) at the smoke config's widths on
    the CPU, where the kernels run their plain versions: the EP train step
    through the kernels against the plain FFN in both modes and the modes
    against each other, the EP-modes benchmark's CPU run, flash decoding
    against dense decode, and the one-rank group (gloo here, NCCL on the
    card) bit-equal to the virtual rank. Without a card the benchmark
    refuses to run unless asked for the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import bench_ep_modes
    cfg = get_smoke_config("granite-moe-3b-a800m")
    par = chip_smoke.ep_parity_case(cfg, n_layers=2, tokens=32, dev="cpu")
    assert set(par["kernels_vs_plain"]) == set(chip_smoke.EP_MODES)
    for g in (*par["kernels_vs_plain"].values(), par["modes"]):
        assert g["loss_rel_gap"] <= chip_smoke.LOSS_TOL
        assert g["grad_norm_rel_gap_max"] <= chip_smoke.GNORM_TOL
    modes = chip_smoke.run_ep_modes(["--device", "cpu"])
    assert modes["phase"] == "ep_modes"
    assert modes["modes"]["hyperparallel"]["ffn_calls"] == 2 * 16
    assert modes["modes"]["baseline"]["collectives"] == {"all-to-all": 2}
    fd = chip_smoke.flash_decode_case(B=4, max_len=32, H=4, K=2, hd=16,
                                      length=17, dtype=torch.float32,
                                      dev="cpu")
    assert fd["caches_equal"] and fd["max_abs_err"] < 1e-5
    d = chip_smoke.dist_case(cfg, backend="gloo", tokens=32, dev="cpu")
    assert all(m["bit_equal"] for m in d["modes"].values())
    assert bench_ep_modes.ffn_calls("hyperparallel", 4, 1) == 16
    assert bench_ep_modes.ffn_calls("baseline", 4, 1) == 4
    caps = chip_smoke.ep_capacities(chip_smoke.get_config(
        "granite-moe-3b-a800m"))
    assert caps == {"ep_train": 688, "paper": 2560}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench_ep_modes.main(["--full"])


def test_ft_cases_on_the_cpu(tmp_path):
    """Phase 15's cases at the smoke size on the CPU (the kernels' plain
    versions; launches are checked on the card only): the resumed run's
    log and state bit-equal to the uninterrupted run's, the checkpoint's
    manifest bytes equal to the state's, every harness check true."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("granite-moe-3b-a800m")
    out, _ = chip_smoke.ft_train_case(cfg, str(tmp_path), dev="cpu", seq=32)
    assert out["resumed_from"] == chip_smoke.FT_EVERY
    assert out["log_bit_equal"] and not out["state_leaves_unequal"]
    assert [m[0] for m in out["log"]] == list(
        range(1, chip_smoke.FT_STEPS + 1))
    assert out["checkpoint_bytes"] == out["state_bytes"] + 4   # int32 step
    assert [e["op"] for e in out["ckpt"]] == ["save", "save", "restore",
                                              "save"]
    assert out["deterministic_algorithms"]
    assert out["restore_device_bytes_added"] is None   # measured on the card
    assert not torch.are_deterministic_algorithms_enabled()
    cells, _ = chip_smoke.ft_harness_case(str(tmp_path / "h"), dev="cpu")
    assert len(cells) == 6 and all(all(c["checks"].values()) for c in cells)
    assert not torch.are_deterministic_algorithms_enabled()


def test_families_phase_runs_on_the_cpu(monkeypatch):
    """Phase 16's cases at the smoke configs on the CPU, where the kernels
    run their plain versions: (a) prefill and teacher-forced decode against
    the forward within FAMILY_TOL for a dense, the ssm and the hybrid arch
    (recurrentgemma's 20-token prompt wraps its 16-slot ring), (b) serving
    and (c) training through the entry points, (d) dbrx's kernel path
    against the plain FFN. The launch counters count only on the card, so
    (d) fails its launch gate here; with the counts its formula gives
    (2 layers x (8 prefills + 31 decode steps)) every other gate holds."""
    from repro_torch.configs import get_smoke_config
    for arch, n, prompt, steps in (("llama3_2-3b", 2, 12, 3),
                                   ("mamba2-1_3b", 2, 16, 8),
                                   ("recurrentgemma-2b", 5, 20, 3)):
        out = chip_smoke.family_consistency_case(
            arch, n, prompt, steps, dev="cpu", cfg=get_smoke_config(arch))
        assert max(out["prefill_max_abs_err"],
                   out["decode_max_abs_err"]) <= out["limit"]
    assert (out["ring_slots"], out["ring_tokens"]) == (16, 23)
    srv = chip_smoke.family_serve_case(
        "recurrentgemma-2b", dev="cpu",
        cfg=get_smoke_config("recurrentgemma-2b"), requests=3, prompt_len=20)
    assert srv["tokens"] == 3 * chip_smoke.MAX_NEW
    assert srv["max_memory_allocated_bytes"] is None
    tr = chip_smoke.family_train_case("mamba2-1_3b", dev="cpu",
                                      argv=("--smoke", "--seq", "16"))
    assert len(tr["losses"]) == chip_smoke.FAMILY_TRAIN_STEPS
    assert not any(tr["launches"].values())
    dbrx_cfg = get_smoke_config("dbrx-132b")
    with pytest.raises(AssertionError, match="dbrx-132b failed"):
        chip_smoke.dbrx_case(dev="cpu", cfg=dbrx_cfg, prompt_len=16)
    counts = dict({k: 0 for k in chip_smoke.COUNTERS}, gmm_swiglu=78, gmm=78)
    monkeypatch.setattr(chip_smoke, "read_launches", lambda: dict(counts))
    out, launches = chip_smoke.dbrx_case(dev="cpu", cfg=dbrx_cfg,
                                         prompt_len=16)
    assert launches == counts and out["expected_launches"] == 78
    assert out["logit_max_abs_err"] <= chip_smoke.LOGIT_TOL * out[
        "logit_max_abs"]
    assert chip_smoke.dbrx_capacities() == {"dbrx_decode8": 3,
                                            "dbrx_prefill": 40,
                                            "dbrx_train": 1280}


def test_dbrx_training_step_case_runs_on_the_cpu(monkeypatch):
    """Phase 16 (e) at dbrx's smoke config on the CPU: the loss and grad
    norms through the kernels' wrappers (their plain versions here) match
    the plain FFN's within phase 5's limits. The launch counters count
    only on the card, so the case fails its launch gate here; with the
    counts its formula gives (2 layers x TRAIN_LAUNCHES, the backward's
    on the tensor cores) every other gate holds."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import gmm_swiglu_bwd as bwd_mod
    cfg = get_smoke_config("dbrx-132b")
    with pytest.raises(AssertionError, match="training step failed"):
        chip_smoke.dbrx_train_case(dev="cpu", cfg=cfg, seq=32)
    want = {k: 2 * n for k, n in chip_smoke.TRAIN_LAUNCHES.items()}
    monkeypatch.setattr(chip_smoke, "reset_launches", lambda: None)
    monkeypatch.setattr(chip_smoke, "read_launches", lambda: dict(want))
    monkeypatch.setattr(bwd_mod, "launches_tc", want["gmm_swiglu_bwd"])
    out, launches = chip_smoke.dbrx_train_case(dev="cpu", cfg=cfg, seq=32)
    assert launches == want == out["expected_launches"]
    assert out["loss_rel_gap"] <= chip_smoke.LOSS_TOL
    assert out["grad_norm_rel_gap_max"] <= chip_smoke.GNORM_TOL
    assert out["grad_leaves"] > 10 and out["tokens"] == 32


def test_audio_vlm_phase_runs_on_the_cpu():
    """Phase 17's cases at the smoke configs on the CPU, where no kernel
    runs: (a) internvl2's prefill with patches and teacher-forced decode
    against the forward, the patches moving the logits; hubert's encoder
    (here the CPU against itself) and its non-causal mask; (b) serving on
    tokens with the patch prefill, hubert's prefill step; (c) both
    trainings; (d) the dry run's check over one grid cell and these runs
    at their own sizes (its shares read CPU times here: no device
    number)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    vlm = get_smoke_config("internvl2-26b")
    audio = get_smoke_config("hubert-xlarge")
    out = chip_smoke.vlm_consistency_case(dev="cpu", cfg=vlm, prompt=12,
                                          steps=3)
    assert out["cache_len"] == vlm.n_patches + 15
    assert max(out["prefill_max_abs_err"],
               out["decode_max_abs_err"]) <= out["limit"]
    out = chip_smoke.audio_consistency_case(dev="cpu", cfg=audio, frames=32)
    assert out["max_abs_err_vs_cpu"] == 0.0
    assert out["first_frame_moved_by"] > out["limit"]
    srv = chip_smoke.family_serve_case("internvl2-26b", dev="cpu", cfg=vlm,
                                       requests=3, prompt_len=12)
    assert srv["tokens"] == 3 * chip_smoke.MAX_NEW
    patch = chip_smoke.prefill_step_case("internvl2-26b", dev="cpu", cfg=vlm,
                                         batch=2, seq=12)
    assert patch["patches"] == vlm.n_patches
    pre = chip_smoke.prefill_step_case("hubert-xlarge", dev="cpu", cfg=audio,
                                       seq=64)
    assert pre["seq"] == 64 and len(pre["ms"]) == chip_smoke.AV_REPEATS
    training = [chip_smoke.av_train_case("hubert-xlarge", dev="cpu",
                                         cfg=audio, seq=32),
                chip_smoke.av_train_case("internvl2-26b", dev="cpu",
                                         cfg=vlm, seq=32)]
    assert [len(t["losses"]) for t in training] == [
        chip_smoke.FAMILY_TRAIN_STEPS] * 2
    assert not any(chip_smoke._sum_launches(*training).values())
    runs = chip_smoke.run_cells(vlm_cfg=vlm, audio_cfg=audio,
                                vlm_train_cfg=vlm, prompt_len=12,
                                patch_batch=2, frames=64, seq=32)
    grid = chip_smoke.dryrun_grid(["olmo-1b"], ["decode_32k"])
    results = dryrun.count_all(grid + list(runs.values()))
    dry = chip_smoke.dryrun_check(
        grid, runs, results,
        chip_smoke.run_measurements(srv, patch, pre, training), 0.0,
        workers=1)
    assert len(dry["cells"]) == 1 and not dry["failures"]
    assert [r["run"] for r in dry["runs"]] == list(runs)
    assert dry["runs"][0]["kind"] == "decode"
    assert dry["runs"][-1]["n_layers"] == vlm.n_layers


def test_tools_phase_runs_on_the_cpu(monkeypatch):
    """Phase 18's cases at the smoke configs on the CPU: (b) every
    variant's real step through ``hillclimb.variant_steps`` over four
    virtual ranks, (a) each counted at the same cut on the meta device,
    joined by ``tools_check`` (the shares read CPU times here: no device
    number); the fp32 decode consistency; (c) the examples. The launch
    counters count only on the card, so the launch gates fail here: with
    the counts ``hillclimb_launches`` gives, every other gate of (b)
    holds, and (c) names exactly the MoE examples."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import hillclimb as hc
    from repro_torch.launch.train import pad_experts
    granite = pad_experts(dataclasses.replace(
        get_smoke_config("granite-moe-3b-a800m"), remat=True), 4)
    llama = get_smoke_config("llama3_2-3b")
    runs = chip_smoke.tools_runs(granite=granite,
                                 hubert=get_smoke_config("hubert-xlarge"),
                                 llama=llama, seq=32, decode_len=64)
    assert len(runs) == 9
    measured = {}
    for label, (cfg, sp, v) in runs.items():
        if sp.kind == "train":
            measured[label] = chip_smoke.tools_train_case(cfg, sp, v,
                                                          dev="cpu", steps=2)
        else:
            measured[label], logits = chip_smoke.tools_decode_case(
                cfg, sp, v, dev="cpu", steps=3)
            assert tuple(logits.shape[:2]) == (4, chip_smoke.DECODE_BATCH)
    results = dryrun.count_all([(c, s, v, chip_smoke.TOOLS_MESH)
                                for c, s, v in runs.values()], 1,
                               hc.count_job)
    with pytest.raises(AssertionError, match="launches"):
        chip_smoke.tools_check(runs, measured, results)
    for label, run in measured.items():
        if label.startswith("granite_"):
            run["launches"] = chip_smoke.hillclimb_launches(run)
            run["tensor_core_launches"] = {
                k: run["launches"][k]
                for k in ("gmm_swiglu", "gmm", "gmm_swiglu_bwd")}
    out = chip_smoke.tools_check(runs, measured, results)
    assert out["baseline_zero1_first_loss_bit_equal"]
    assert out["runs"]["granite_ep_dp"]["counted_collectives"] == {
        "collective-permute": out["runs"]["granite_ep_dp"][
            "counted_collectives"]["collective-permute"]}
    assert out["runs"]["llama_baseline"]["collectives"] == {
        "all-reduce": 3 * llama.n_layers}
    assert chip_smoke.hillclimb_launches(
        measured["granite_zero1_noremat"])["gmm"] == 3 * 2 * 16 * 2
    fp32 = dataclasses.replace(llama, dtype="float32")
    cons = chip_smoke.tools_decode_consistency(cfg=fp32, dev="cpu",
                                               max_len=64, steps=2)
    assert cons["of_max_logit"] <= chip_smoke.FAMILY_TOL
    monkeypatch.setattr(chip_smoke, "E2E_STEPS", 2)
    with pytest.raises(AssertionError, match="phase 18 .c. failed") as e:
        chip_smoke.tools_examples(
            dev="cpu", quick_argv=["--steps", "2"], explorer_argv=[
                "--ep", "2"], serve_argv=["--batch", "2", "--gen", "3",
                                          "--prompt-len", "8"],
            e2e_argv=["--seq", "16", "--batch", "2"])
    named = [n for n in ("quickstart", "schedule_explorer", "serve_decode'",
                         "serve_decode_moe", "train_moe_e2e")
             if f"('{n}" in str(e.value)]
    assert named == ["quickstart", "serve_decode_moe", "train_moe_e2e"]


def test_tools_cells_gates_on_failures_and_moe_collectives():
    """Phase 18 (a)'s join of the three cells' counts: one row a cell and
    variant in ``hillclimb.CELLS`` order; it fails on a failed count, and
    on a MoE cell's variant that counts no collective (EP is on in each)."""
    row = {"tag": "t", "line": "l", "t_compute_s": 1.0, "t_memory_s": 2.0,
           "t_collective_s": 0.5, "bottleneck": "memory",
           "roofline_frac": 0.1, "collectives": {"all-to-all": 1},
           "collective_bytes_per_rank": 8.0, "args_gb": 1.0, "temp_gb": 1.0,
           "count_s": 1.0}
    n = 3 * len(chip_smoke.TOOLS_CELL_VARIANTS)
    rows = chip_smoke.tools_cells([(row, None)] * n)
    assert [(r["cell"], r["variant"]) for r in rows][:2] == [
        ("granite_train", "baseline"), ("granite_train", "opt")]
    assert len(rows) == n
    with pytest.raises(AssertionError, match="no collective counted"):
        chip_smoke.tools_cells([(dict(row, collectives={}), None)] * n)
    with pytest.raises(AssertionError, match="boom"):
        chip_smoke.tools_cells([(row, None)] * (n - 1)
                               + [(None, ("llama", "decode", "opt", "boom"))])


def test_dist_train_phase_runs_on_the_cpu():
    """Phase 19 at the smoke config's widths on the CPU: ``launch.train
    --nproc 4 --backend gloo`` on mesh 2x2 in zero1 and ep_dp, each within
    LOSS_TOL / GNORM_TOL of the one-process run over virtual ranks, each
    process's optimizer state its spec's blocks, and the processes'
    checkpoint restored here to every rank's blocks (launches are checked
    on the card only, the NCCL try needs it)."""
    out, launches = chip_smoke.run_dist_train(smoke=True, dev="cpu",
                                              seq=32, nccl=False)
    assert out["phase"] == "dist_train"
    assert set(out["modes"]) == set(chip_smoke.DIST_MODES)
    for row in out["modes"].values():
        assert row["loss_rel_gap"] <= chip_smoke.LOSS_TOL
        assert row["grad_leaf_norm_rel_gap_max"] <= chip_smoke.GNORM_TOL
        assert row["opt_state_bytes_per_process"] == [
            row["opt_state_bytes_by_spec"]] * chip_smoke.DIST_PROCS
        assert len(row["losses"]) == chip_smoke.DIST_STEPS
        assert len(row["comm_s_per_step"]) == chip_smoke.DIST_STEPS - 1
    restore = out["modes"][chip_smoke.DIST_MODES[-1]]["restore"]
    assert restore["blocks_checked"] > 0 and not restore["blocks_unequal"]
    # The plain versions ran on the CPU: no kernel launch was counted.
    assert set(launches) == set(chip_smoke.COUNTERS)


def test_dist_dropless_phase_runs_on_the_cpu(monkeypatch):
    """Phase 19b at the smoke config's widths on the CPU: ``launch.train
    --nproc 4 --backend gloo --dropless`` on mesh 2x2 in ep_dp and tp_sp,
    each within LOSS_TOL / GNORM_TOL of the one-process dropless steps,
    every process 2 x layers SSC lookups a step (all misses on step 0),
    its params and optimizer state its spec blocks (launches are checked
    on the card only). The gates fire on the same run's records when the
    yardstick's loss is wrong and when it wants twice the lookups. Both
    modes run in one spawn of the processes."""
    import copy
    runs = []
    main_runs = chip_smoke.train_mod.main_runs

    def keep(argvs, **kw):
        runs.extend(main_runs(argvs, **kw))
        return copy.deepcopy(runs)
    monkeypatch.setattr(chip_smoke.train_mod, "main_runs", keep)
    out, launches = chip_smoke.run_dist_dropless(smoke=True, dev="cpu",
                                                 seq=32)
    assert len(runs) == len(chip_smoke.DROPLESS_DIST_MODES)  # one spawn
    assert out["phase"] == "dist_dropless"
    assert set(out["modes"]) == set(chip_smoke.DROPLESS_DIST_MODES)
    n = 2 * chip_smoke.DIST_LAYERS
    assert out["one_process"]["ssc_lookups"] == n
    for row in out["modes"].values():
        assert row["loss_rel_gap"] <= chip_smoke.LOSS_TOL
        assert row["grad_leaf_norm_rel_gap_max"] <= chip_smoke.GNORM_TOL
        assert row["opt_state_bytes_per_process"] == [
            row["opt_state_bytes_by_spec"]] * chip_smoke.DIST_PROCS
        assert row["param_bytes_per_process"] == [
            row["param_bytes_by_spec"]] * chip_smoke.DIST_PROCS
        assert len(row["losses"]) == chip_smoke.DIST_STEPS
        assert "all-gather" in row["collectives_per_rank_per_step"]
        for ssc in row["ssc_per_process"]:
            assert [s["ssc_hits"] + s["ssc_misses"] for s in ssc] == [
                n] * chip_smoke.DIST_STEPS
            assert ssc[0]["ssc_misses"] == n
    assert set(launches) == set(chip_smoke.COUNTERS)
    # The gates, on the ep_dp run's own records.
    pcfg, want = chip_smoke.dist_config(True), out["one_process"]
    run = runs[chip_smoke.DROPLESS_DIST_MODES.index("ep_dp")]
    for bad in (dict(want, loss=2 * want["loss"]),
                dict(want, ssc_lookups=2 * n)):
        with pytest.raises(AssertionError, match="ep_dp"):
            chip_smoke.dist_run_case(pcfg, copy.deepcopy(run), mode="ep_dp",
                                     want=bad, dev="cpu", seq=32,
                                     dropless=True)


def test_dist_tp_phase_runs_on_the_cpu():
    """Phase 20 at the smoke config's widths on the CPU: ``launch.train
    --nproc 4 --backend gloo --mode tp_sp`` on mesh 2x2, without then with
    FSDP, each within LOSS_TOL / GNORM_TOL of the one-process tp_sp run
    over virtual ranks, each process's params and optimizer state its spec
    blocks (fewer with FSDP), and the FSDP run's checkpoint restored here
    to every rank's blocks (launches are checked on the card only); then
    (b) the other families' runs, one spawn of 4 processes for all, each
    held to its virtual run and its spec blocks the same way."""
    out, launches = chip_smoke.run_dist_tp(smoke=True, dev="cpu", seq=32)
    assert out["phase"] == "dist_tp"
    assert set(out["runs"]) == set(chip_smoke.DIST_TP_RUNS)
    for row in out["runs"].values():
        assert row["loss_rel_gap"] <= chip_smoke.LOSS_TOL
        assert row["grad_leaf_norm_rel_gap_max"] <= chip_smoke.GNORM_TOL
        assert row["opt_state_bytes_per_process"] == [
            row["opt_state_bytes_by_spec"]] * chip_smoke.DIST_PROCS
        assert row["param_bytes_per_process"] == [
            row["param_bytes_by_spec"]] * chip_smoke.DIST_PROCS
        assert len(row["losses"]) == chip_smoke.DIST_STEPS
        assert {"all-gather", "reduce-scatter"} <= set(
            row["collectives_per_rank_per_step"])
    plain, fsdp = (out["runs"][k] for k in chip_smoke.DIST_TP_RUNS)
    assert fsdp["param_bytes_by_spec"] < plain["param_bytes_by_spec"]
    restore = fsdp["restore"]
    assert restore["blocks_checked"] > 0 and not restore["blocks_unequal"]
    assert set(launches) == set(chip_smoke.COUNTERS)
    fams = out["families"]["runs"]
    assert set(fams) == set(chip_smoke.DIST_FAMILIES)
    for arch, row in fams.items():
        assert row["n_layers"] == chip_smoke.DIST_FAMILIES[arch][0]
        assert row["loss_rel_gap"] <= chip_smoke.LOSS_TOL
        assert row["grad_leaf_norm_rel_gap_max"] <= chip_smoke.GNORM_TOL
        assert row["param_bytes_per_process"] == [
            row["param_bytes_by_spec"]] * chip_smoke.DIST_PROCS
        assert row["opt_state_bytes_per_process"] == [
            row["opt_state_bytes_by_spec"]] * chip_smoke.DIST_PROCS
        assert len(row["losses"]) == chip_smoke.DIST_FAMILY_STEPS
        assert {"all-gather", "reduce-scatter"} <= set(
            row["collectives_per_rank_per_step"])
    assert "all-to-all" in fams["gemma-2b"][
        "collectives_per_rank_per_step"]             # the GLU's pairing
    assert "all-to-all" not in fams["hubert-xlarge"][
        "collectives_per_rank_per_step"]             # GELU lines up
    # (b)'s fp32 yardstick runs for mamba2 alone.
    assert [a for a, row in fams.items() if row["bf16_vs_fp32"]] == list(
        chip_smoke.DIST_FP32_ARCHS)
    # (c) serving in the same spawn: every layout's logits within the
    # gate of its one-process run, its cache its cache_spec blocks.
    serving = out["families"]["serving"]
    assert set(serving) == set(chip_smoke.SERVE_LAYOUTS)
    for name, row in serving.items():
        arch, mode, rows = chip_smoke.SERVE_LAYOUTS[name]
        assert (row["mode"], row["rows"]) == (mode, rows)
        assert row["logit_rel_gap_max"] <= chip_smoke.LOGIT_TOL
        if arch == "hubert-xlarge":                  # a forward, no cache
            assert row["decode_ms_median"] is None
            continue
        assert row["cache_bytes_per_process"] == [
            [row["cache_bytes_by_spec"]] * 2] * chip_smoke.DIST_PROCS
        assert len(row["comm_s_per_step"]) == chip_smoke.SERVE_NEW
        assert "all-reduce" in row["decode_collectives"]   # flash decoding
    assert "all-to-all" in serving[f"{chip_smoke.ARCH}/tp_sp"][
        "prefill_collectives"]           # the cache's slots and EP's tokens
    assert serving[f"{chip_smoke.ARCH}/zero1"]["rows"] == 2


def test_dist_expected_bytes_at_full_width():
    """Phase 20's spec blocks at granite's full width cut to 2 layers: a
    process holds 195.58 M params in tp_sp (half of the 391.17 M) and
    135.81 M with FSDP, and 12 bytes of fp32 AdamW state each (zero1's
    ZeRO-1 state beside it)."""
    cfg = chip_smoke.dist_config()
    n_tp, b_tp = chip_smoke.dist_expected_params(cfg, "tp_sp", False)
    n_fs, b_fs = chip_smoke.dist_expected_params(cfg, "tp_sp", True)
    assert (n_tp, n_fs) == (195_583_488, 135_814_656)
    assert (b_tp, b_fs) == (2 * n_tp, 2 * n_fs)          # bf16
    assert chip_smoke.dist_expected_opt_bytes(cfg, "tp_sp", False) == \
        12 * n_tp
    assert chip_smoke.dist_expected_opt_bytes(cfg, "tp_sp", True) == \
        12 * n_fs
    assert chip_smoke.dist_expected_opt_bytes(cfg, "zero1") < 12 * n_fs


@pytest.mark.parametrize("arch,params", [
    ("gemma-2b", 372_254_720), ("mamba2-1.3b", 77_500_032),
    ("recurrentgemma-2b", 547_950_080), ("internvl2-26b", 764_442_624),
    ("hubert-xlarge", 20_974_080)])
def test_dist_family_blocks_at_full_width(arch, params):
    """Phase 20 (b)'s spec blocks at full width cut in depth: a process
    holds its blocks of the cut model in tp_sp (internvl2, with FSDP, a
    quarter of its layers and half of its two vocabulary tables) in bf16,
    and 12 bytes of fp32 AdamW state a param."""
    cfg = chip_smoke.dist_family_config(arch)
    fsdp = chip_smoke.DIST_FAMILIES[arch][1]
    n, b = chip_smoke.dist_expected_params(cfg, "tp_sp", fsdp)
    assert n == params and b == 2 * n
    assert chip_smoke.dist_expected_opt_bytes(cfg, "tp_sp", fsdp) == 12 * n


def test_dist_capacity_is_the_ring_chunk_of_a_ranks_rows():
    """Phase 3 checks the kernels at phases 19 and 20's ring chunk: a
    rank's DIST_BATCH x TRAIN_SEQ / DIST_PROCS tokens (one 4,096-token row,
    in zero1's sequence chunks as in ep_dp's rows; in tp_sp two rows'
    2,048-token chunks) at ep = DIST_MESH[-1]."""
    from repro_torch.parallel.ep import _pair_capacity
    cfg = chip_smoke.get_config(chip_smoke.ARCH)
    tokens = chip_smoke.DIST_BATCH * chip_smoke.TRAIN_SEQ // (
        chip_smoke.DIST_PROCS)
    assert chip_smoke.dist_capacity(cfg) == _pair_capacity(
        tokens, cfg.moe, chip_smoke.DIST_MESH[-1], chip_smoke.EP_CF) == 2736


def test_prod_dryrun_phase_runs_on_the_cpu():
    """Phase 21 at the smoke config's widths on the CPU: (a) one tp_sp
    launcher step of each of phase 20's runs (4 gloo processes, mesh 2x2)
    held to its count on a counting mesh, collectives and bytes, (b) a few
    cells counted in 2 worker processes, started before (a) and run
    beside it as beside phases 7-16 on the card, on 2x2 and 2x2x2 meshes (the
    smoke configs' 6 experts do not split over 16 ranks), every row's
    FLOPs a device times its chips above the floor."""
    from repro_torch.launch import train as ttrain
    cells = [("llama3.2-3b", "tp_sp", "2x2"),
             ("granite-moe-3b-a800m", "zero1", "2x2x2"),
             ("granite-moe-3b-a800m", "ep_dp", "2x2")]
    serve_cells = [("granite-moe-3b-a800m", "decode_32k"),
                   ("recurrentgemma-2b", "long_500k")]
    counts = chip_smoke.BackgroundCounts({"prod": chip_smoke.prod_cells(
        smoke=True, cells=cells,
        shape=chip_smoke.ShapeSpec("train_4k", 32, 8, "train"),
        serve_cells=serve_cells, serve_mesh="2x2")}, workers=2)
    runs = {}
    for name, fsdp in chip_smoke.DIST_TP_RUNS.items():
        run = ttrain.main(
            ["--smoke", "--device", "cpu", "--backend", "gloo", "--nproc",
             "4", "--mesh", "x".join(map(str, chip_smoke.DIST_MESH)),
             "--mode", "tp_sp", "--seq", "32", "--global-batch",
             str(chip_smoke.DIST_BATCH), "--steps", "1", "--n-layers",
             str(chip_smoke.DIST_LAYERS)], fsdp=fsdp)
        rec = run.metrics_log[-1]
        runs[name] = {"collectives_per_rank_per_step": rec["collectives"],
                      "comm_bytes_per_rank_per_step":
                          rec["comm_bytes_per_rank"]}
    served = chip_smoke.dist_serve_spawn(f"{chip_smoke.ARCH}/tp_sp")
    out = chip_smoke.run_prod_dryrun(runs, counts, smoke=True, seq=32,
                                     served=served)
    assert out["phase"] == "dryrun_meshes"
    serve = out["counted_dist_tp"].pop("serve")
    for name, row in out["counted_dist_tp"].items():
        assert row["forward_collectives"] == row["processes_collectives"]
        assert row["all_transfer_bytes"] > row["forward_bytes"] > 0
    for step, row in serve.items():
        assert row["forward_collectives"] == row["processes_collectives"]
        assert row["forward_bytes"] == row["processes_bytes"] > 0
    assert not out["failures"] and not out["flops_below_floor"]
    assert [(r["mode"], r["mesh"], r["chips"], r["shape"])
            for r in out["rows"]] == [
        ("tp_sp", "2x2", 4, "train_4k"), ("zero1", "2x2x2", 8, "train_4k"),
        ("ep_dp", "2x2", 4, "train_4k"), ("tp_sp", "2x2", 4, "decode_32k"),
        ("tp_sp", "2x2", 4, "long_500k")]
    assert len(chip_smoke.PROD_CELLS) == 18
    assert len(chip_smoke.PROD_SERVE_CELLS) == 8
