"""Helpers of ``chip_smoke.py`` that run without a card: the precision
control of the trainable expert FFN's end-to-end check, the reader of the
compiler's register and spill report, the dropless tiles' body check,
phase 9's SSC lookups check and the cases of phases 10-12 and 14-17."""

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


def _tile_row(rows, body, launched, shape="dropless_tile"):
    row = {"kernel": "gmm", "C": rows, "body": body,
           "tiled_launches": launched, "shape": shape}
    if shape == "dropless_tile":
        row["rows"] = rows
    return row


def test_dropless_body_check_counts_the_tiled_rows():
    wgrad_of_one_row = dict(_tile_row(1, "small", 0), C=1536, K=1)
    rows = [_tile_row(683, "tiled", 1), _tile_row(1, "small", 0),
            wgrad_of_one_row, _tile_row(15, "tiled", 1),
            _tile_row(129, "small", 0, shape="dropless_edge")]
    assert chip_smoke.check_fp32_bodies(rows, 16) == 2


@pytest.mark.parametrize("bad", [
    _tile_row(683, "small", 0),             # a tile call the rule sends on
    dict(_tile_row(683, "small", 0), C=1536, K=683),   # its weight gradient
    _tile_row(16, "small", 0),              # the threshold itself
    _tile_row(683, "tiled", 0),           # named, but not launched
    _tile_row(1, "small", 1, shape="dropless_edge"),   # launched, not named
])
def test_dropless_body_check_fails_on_a_wrong_body(bad):
    rows = [_tile_row(683, "tiled", 1), bad]
    with pytest.raises(AssertionError, match="wrong body"):
        chip_smoke.check_fp32_bodies(rows, 16)


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
