"""Schedule-compilation pass pipeline — §4.5's optimizations as compiler
passes over a shared task abstraction.

The seed reproduction hardcoded each execution-order optimization as a
boolean kwarg threaded through ``compile_schedule``, ``SSCCache.key`` and
every caller; adding an optimization meant widening every signature.
FlowMoE frames this as a *scheduling-pass* problem: each optimization is a
named, parameterized transform over the compiled ``Schedule``, and a
:class:`Pipeline` — an ordered, serializable list of pass specs — is the
single object that travels through compilation, the SSC cache key, the SSC
blob itself, and the hillclimb variant space.

Contract for a registered pass (the ``SchedulePass`` protocol):

* signature ``fn(sched, cfg, **params)``, mutating ``sched.queues`` in
  place;
* it may only permute mutually independent tasks — events, tile ranges and
  task membership are frozen (``validate_schedule`` re-proves legality
  after the whole pipeline runs);
* ``params`` must be msgpack-serializable scalars so the spec round-trips
  through the SSC blob byte-identically.

Back-compat: the seed's ``ratr=`` / ``gmm_interleave=`` /
``chain_interleave=`` kwargs are shimmed through
:func:`pipeline_from_flags`, which maps them onto the equivalent canonical
pipeline — compiling with the old flags and with the equivalent pipeline
spec produces byte-identical SSC blobs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Protocol, Union, runtime_checkable

from .odg import ScheduleConfig


@runtime_checkable
class SchedulePass(Protocol):
    """A registered schedule transform: ``fn(sched, cfg, **params)``."""

    def __call__(self, sched, cfg: ScheduleConfig, **params) -> None: ...


_PASS_REGISTRY: dict[str, Callable] = {}


def register_pass(name: str):
    """Register a :class:`SchedulePass` implementation under ``name``."""
    def deco(fn):
        if name in _PASS_REGISTRY:
            raise ValueError(f"schedule pass {name!r} already registered")
        _PASS_REGISTRY[name] = fn
        return fn
    return deco


def get_pass(name: str) -> Callable:
    try:
        return _PASS_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown schedule pass {name!r}; registered passes: "
                       f"{registered_passes()}") from None


def registered_passes() -> tuple[str, ...]:
    return tuple(sorted(_PASS_REGISTRY))


@dataclasses.dataclass(frozen=True)
class PassSpec:
    """One named pass plus its (sorted, hashable) parameter overrides."""

    name: str
    params: tuple = ()          # sorted (key, value) pairs

    @classmethod
    def of(cls, name: str, **params) -> "PassSpec":
        get_pass(name)          # fail fast on unknown names
        return cls(name=name, params=tuple(sorted(params.items())))

    def spec(self) -> list:
        """msgpack/JSON-friendly form: ``[name, {param: value}]``."""
        return [self.name, {k: v for k, v in self.params}]

    def run(self, sched, cfg: ScheduleConfig) -> None:
        get_pass(self.name)(sched, cfg, **dict(self.params))


PassLike = Union[str, tuple, list, PassSpec]


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """Ordered, serializable pass list — the `opts` of a compiled Schedule."""

    passes: tuple[PassSpec, ...] = ()

    @classmethod
    def of(cls, *items: PassLike) -> "Pipeline":
        """Build from pass names, ``[name, params]`` pairs, or PassSpecs."""
        specs = []
        for it in items:
            if isinstance(it, PassSpec):
                specs.append(it)
            elif isinstance(it, str):
                specs.append(PassSpec.of(it))
            elif isinstance(it, (tuple, list)) and len(it) == 2:
                specs.append(PassSpec.of(it[0], **dict(it[1])))
            else:
                raise TypeError(f"cannot interpret {it!r} as a pass spec")
        return cls(passes=tuple(specs))

    @classmethod
    def from_spec(cls, spec) -> "Pipeline":
        """Inverse of :meth:`spec` (e.g. from a deserialized SSC blob)."""
        return cls.of(*spec)

    def spec(self) -> list:
        return [p.spec() for p in self.passes]

    def key(self) -> tuple:
        """Hashable identity for SSC-cache keys."""
        return tuple((p.name, p.params) for p in self.passes)

    def names(self) -> tuple[str, ...]:
        return tuple(p.name for p in self.passes)

    def run(self, sched, cfg: ScheduleConfig) -> None:
        for p in self.passes:
            p.run(sched, cfg)

    def __bool__(self) -> bool:
        return bool(self.passes)


EMPTY_PIPELINE = Pipeline()


# The canonical named-pipeline table: the variant space the hillclimb sweep
# (``repro.launch.hillclimb --sched-sweep``), the cost-model-guided selector
# (``core/autoselect.py``) and the docs all enumerate. One registry — a newly
# registered pass joins sweep, selector and docs by adding one entry here.
# Values are serializable pipeline specs (resolvable via ``Pipeline.of``).
SCHED_PIPELINES: dict[str, tuple[str, ...]] = {
    "naive": (),
    "ratr": ("ratr",),
    "ratr+gmm_il": ("ratr", "gmm_interleave"),
    "ratr+crit": ("ratr", "critical_rank_first"),
    "all": ("ratr", "gmm_interleave", "critical_rank_first"),
}


def pipeline_arg(spec: str):
    """Map a CLI ``--sched`` string onto a pipeline request.

    ``"auto"`` stays the literal auto-selection request (resolved by
    ``compile_schedule`` / ``SSCCache`` against the actual plan); a
    ``SCHED_PIPELINES`` name maps to its registered spec; anything else is
    a comma-separated pass-name list, validated against the registry.
    """
    if spec == "auto":
        return "auto"
    if spec in SCHED_PIPELINES:
        return SCHED_PIPELINES[spec]
    names = tuple(s.strip() for s in spec.split(",") if s.strip())
    for n in names:
        get_pass(n)                 # fail fast on unknown names
    return names


def pipeline_from_flags(*, ratr: bool = False, gmm_interleave: bool = False,
                        chain_interleave: bool = False) -> Pipeline:
    """Map the seed's boolean kwargs onto the canonical equivalent pipeline.

    The order matches the seed's ``apply_reorderings`` application order, so
    flag-compiled and pipeline-compiled schedules are byte-identical.
    """
    names = []
    if ratr:
        names.append("ratr")
    if gmm_interleave:
        names.append("gmm_interleave")
    if chain_interleave:
        names.append("chain_interleave")
    return Pipeline.of(*names)


def resolve_pipeline(pipeline=None, *, ratr: bool = False,
                     gmm_interleave: bool = False,
                     chain_interleave: bool = False) -> Pipeline:
    """Normalize a pipeline argument or legacy boolean flags to a Pipeline."""
    if pipeline is not None:
        if ratr or gmm_interleave or chain_interleave:
            raise ValueError(
                "pass either pipeline= or the legacy boolean flags, not both")
        if isinstance(pipeline, Pipeline):
            return pipeline
        if isinstance(pipeline, str):      # a single bare pass name
            if pipeline == "auto":
                raise ValueError(
                    'pipeline="auto" must be resolved against a '
                    "ScheduleConfig first (core/autoselect.auto_pipeline); "
                    "compile_schedule and SSCCache do this for you")
            return Pipeline.of(pipeline)
        return Pipeline.of(*pipeline)
    return pipeline_from_flags(ratr=ratr, gmm_interleave=gmm_interleave,
                               chain_interleave=chain_interleave)


# ---------------------------------------------------------------------------
# Built-in passes (§4.5 reorderings + the straggler-aware extension).
# Implementations live in core/reorder.py; these wrappers own registration
# and any direction gating.
# ---------------------------------------------------------------------------

# ``critical_rank_first`` fires above this compile-time straggler ratio.
# One definition, three consumers: the pass wrapper below, the
# implementation default (core/reorder.py), and the auto-selector's
# fires/no-op gating (core/autoselect.py) — if they diverged, selection
# would price a pass effect the real pass never applies.
CRIT_STRAGGLER_THRESHOLD = 1.05

@register_pass("ratr")
def _pass_ratr(sched, cfg: ScheduleConfig) -> None:
    from .reorder import apply_ratr
    apply_ratr(sched, cfg)


@register_pass("gmm_interleave")
def _pass_gmm_interleave(sched, cfg: ScheduleConfig) -> None:
    from .reorder import apply_gmm_interleave
    if sched.direction == "backward":   # branch pairs only exist backward
        apply_gmm_interleave(sched, cfg)


@register_pass("chain_interleave")
def _pass_chain_interleave(sched, cfg: ScheduleConfig, *,
                           lag: int = 50) -> None:
    from .reorder import apply_chain_interleave
    apply_chain_interleave(sched, lag=lag)


@register_pass("critical_rank_first")
def _pass_critical_rank_first(sched, cfg: ScheduleConfig, *,
                              threshold: float = CRIT_STRAGGLER_THRESHOLD,
                              lag: int = 0) -> None:
    from .reorder import apply_critical_rank_first
    apply_critical_rank_first(sched, cfg, threshold=threshold, lag=lag)


@register_pass("hier_dispatch")
def _pass_hier_dispatch(sched, cfg: ScheduleConfig) -> None:
    """Node-ring ordering for two-level dispatch stage puts. Stable no-op
    on flat schedules (no ``stage``-tagged tasks) and without a topology,
    so it composes freely into any pipeline."""
    from .reorder import apply_hier_dispatch
    apply_hier_dispatch(sched, cfg)


@register_pass("fuse_boundary")
def _pass_fuse_boundary(sched, cfg: ScheduleConfig) -> None:
    """Fragment-spanning pass for fused schedules (core/fusion.py): hoist
    each fragment's combine tiles toward the destination ranks with the
    most next-fragment dispatch traffic. No-op on single-fragment
    schedules."""
    from .reorder import apply_fuse_boundary
    apply_fuse_boundary(sched, cfg)


@register_pass("pp_interleave")
def _pass_pp_interleave(sched, cfg: ScheduleConfig) -> None:
    """Cell-spanning pass for PP-fused schedules (compile_pp_fused): hoist
    each (stage, microbatch) cell's combine tiles toward the ranks with
    the heaviest *same-microbatch next-stage* dispatch traffic — the 1F1B
    analogue of ``fuse_boundary``, which would mis-resolve the downstream
    cell under the wave order. No-op without pp_stage metadata."""
    from .reorder import apply_pp_interleave
    apply_pp_interleave(sched, cfg)
