"""Scheduler registry: declarative registration + capability flags.

Every placement algorithm registers itself under its paper name with a
:class:`SchedulerCapabilities` declaration, replacing the old
``make_scheduler`` if-chain and the name-string matching the simulator
used to decide which schedulers may grow parity on reschedule
(``Simulator._dynamic()``).  Callers resolve algorithms through
:func:`create_scheduler` / :func:`get_spec`; parameterized families
(``ec(K,P)``) register a regex pattern once and any concrete
instantiation resolves on demand.

Usage::

    @register_scheduler("drex_lb", adaptive=True, supports_parity_growth=True)
    class DRexLB(Scheduler): ...

    @register_scheduler_family(r"ec\\((\\d+),(\\d+)\\)")
    class StaticEC(Scheduler):
        def __init__(self, k: int, p: int): ...

    sched = create_scheduler("ec(6,3)")
    get_spec("drex_lb").capabilities.supports_parity_growth  # True
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import re
from typing import Callable, Optional

__all__ = [
    "SchedulerCapabilities",
    "SchedulerSpec",
    "register_scheduler",
    "register_scheduler_family",
    "create_scheduler",
    "get_spec",
    "scheduler_names",
    "scheduler_capabilities",
    "find",
]


@dataclasses.dataclass(frozen=True)
class SchedulerCapabilities:
    """What a scheduler declares about itself (consumed by the simulator,
    the checkpoint manager and the benchmarks instead of name matching)."""

    #: chooses (K, P) per item instead of a fixed code.
    adaptive: bool = False
    #: may add parity chunks when repairing after node failures (§5.7).
    #: Consumed by ``PlacementEngine.plan_repair``: parity growth happens
    #: only when the caller allows it AND this flag is declared.
    supports_parity_growth: bool = False
    #: placement depends on an RNG seed (mapping not a pure function of
    #: the cluster state alone).
    randomized: bool = False
    #: provides ``place_batch(items, cluster, ctx)``: scores a whole batch
    #: against one cluster snapshot in a single vectorized call, returning
    #: decisions identical to sequential ``place`` while the cluster is
    #: unchanged.  Consumed by ``PlacementEngine.place_many`` (which
    #: re-scores items invalidated by a commit); never match on names.
    #: Declared by D-Rex SC (core/sc_kernel), both greedy baselines
    #: (core/greedy_kernel) and D-Rex LB (core/lb_kernel), which score the
    #: batch on their device; the scalar paths survive as the equivalence
    #: oracles (``place_scalar``).
    batch_scoring: bool = False
    #: consumes :class:`~repro_torch.core.types.PlacementConstraints`: ``place``
    #: / ``place_batch`` accept a ``constraints=`` keyword and build their
    #: candidate orders through ``core.constraints.constrained_order`` (and
    #: ``prefilter.domain_slice``), so per-domain caps hold by construction
    #: and the engine's swap post-pass only ever has to enforce spread.
    #: Non-declaring schedulers never receive the keyword; the engine
    #: repairs their mappings with the post-pass instead.
    topology_aware: bool = False
    #: ``place_batch`` decisions carry a ``Decision.window`` naming the
    #: node ids their score depends on, and the decision is a pure
    #: function of (item, failure probs, the free-desc order of live
    #: nodes, free space of the window nodes) — nothing else.  Lets the
    #: engine's dependency-aware rescoring keep a pending score across a
    #: commit that is disjoint from its window and leaves the free-desc
    #: order unchanged.  Schedulers whose scores depend on cluster-global
    #: terms (D-Rex LB's ``f_avg``, D-Rex SC's saturation baseline,
    #: GreedyMinStorage's cluster-wide capacity filter) must NOT declare
    #: this; only GreedyLeastUsed qualifies among the built-ins.
    windowed_scoring: bool = False


@dataclasses.dataclass(frozen=True)
class SchedulerSpec:
    name: str
    factory: Callable
    capabilities: SchedulerCapabilities
    doc: str = ""


_REGISTRY: dict[str, SchedulerSpec] = {}
_FAMILIES: list[tuple[re.Pattern, Callable, SchedulerCapabilities, str]] = []


def register_scheduler(
    name: str,
    *,
    adaptive: bool = False,
    supports_parity_growth: bool = False,
    randomized: bool = False,
    batch_scoring: bool = False,
    windowed_scoring: bool = False,
    topology_aware: bool = False,
    doc: str = "",
):
    """Class/factory decorator adding one named algorithm to the registry.

    The capability record is also attached to the factory as
    ``.capabilities`` so instances can be interrogated directly
    (``scheduler.capabilities.supports_parity_growth``).
    """
    caps = SchedulerCapabilities(
        adaptive=adaptive,
        supports_parity_growth=supports_parity_growth,
        randomized=randomized,
        batch_scoring=batch_scoring,
        windowed_scoring=windowed_scoring,
        topology_aware=topology_aware,
    )

    def deco(factory):
        key = name.lower()
        # Latest registration wins: re-decorating the same name (module
        # reload, test fixtures) stays idempotent instead of raising.
        _REGISTRY[key] = SchedulerSpec(
            key, factory, caps, doc or inspect.getdoc(factory) or ""
        )
        try:
            factory.capabilities = caps
        except (AttributeError, TypeError):  # e.g. functools.partial
            pass
        return factory

    return deco


def register_scheduler_family(
    pattern: str,
    *,
    adaptive: bool = False,
    supports_parity_growth: bool = False,
    randomized: bool = False,
    batch_scoring: bool = False,
    windowed_scoring: bool = False,
    topology_aware: bool = False,
    doc: str = "",
):
    """Register a parameterized family, e.g. ``ec(K,P)``.

    ``pattern`` is a regex whose groups are passed to the factory as int
    positional arguments; any name fully matching it resolves (and is
    memoized into the registry so it appears in :func:`scheduler_names`).
    """
    caps = SchedulerCapabilities(
        adaptive=adaptive,
        supports_parity_growth=supports_parity_growth,
        randomized=randomized,
        batch_scoring=batch_scoring,
        windowed_scoring=windowed_scoring,
        topology_aware=topology_aware,
    )

    def deco(factory):
        _FAMILIES.append(
            (re.compile(pattern), factory, caps, doc or inspect.getdoc(factory) or "")
        )
        try:
            factory.capabilities = caps
        except (AttributeError, TypeError):
            pass
        return factory

    return deco


def _resolve_family(name: str) -> Optional[SchedulerSpec]:
    for rx, factory, caps, doc in _FAMILIES:
        m = rx.fullmatch(name)
        if m is None:
            continue
        args = tuple(int(g) for g in m.groups())
        spec = SchedulerSpec(name, functools.partial(factory, *args), caps, doc)
        _REGISTRY[name] = spec
        return spec
    return None


def get_spec(name: str) -> SchedulerSpec:
    """Look up a registered scheduler (or instantiate a family match).

    Names are case- and whitespace-insensitive (``"EC(6, 3)"`` resolves
    to ``ec(6,3)``, matching the old factory's tolerance)."""
    key = "".join(name.lower().split())
    spec = _REGISTRY.get(key) or _resolve_family(key)
    if spec is None:
        raise ValueError(
            f"unknown scheduler {name!r}; registered: {scheduler_names()}"
        )
    return spec


def create_scheduler(name: str, device=None, **kwargs):
    """Instantiate a scheduler by registered name (the factory behind the
    old ``make_scheduler``).  ``device`` goes to the kernel-backed
    schedulers — those whose factory takes a ``device`` argument (``None``
    means CUDA) — and is not used by the host-only ones."""
    factory = get_spec(name).factory
    if "device" in inspect.signature(factory).parameters:
        kwargs["device"] = device
    return factory(**kwargs)


def scheduler_names() -> list[str]:
    """All names registered so far (family members appear once resolved)."""
    return sorted(_REGISTRY)


def find(
    capabilities: Optional[dict] = None, **flags: bool
) -> list[SchedulerSpec]:
    """Query the registry by capability flags instead of poking classes.

    Each given flag must match the spec's declared value exactly; flags
    left out do not filter.  ``capabilities`` may be passed as a dict
    (``find(capabilities={"topology_aware": True})``) or as keyword
    flags (``find(topology_aware=True, batch_scoring=True)``).  Only
    concrete registrations are searched — family patterns (``ec(K,P)``)
    appear once a member has been resolved.  Results are name-sorted for
    deterministic sweeps (the invariant harness iterates this).
    """
    wanted = dict(capabilities or {})
    wanted.update(flags)
    valid = {f.name for f in dataclasses.fields(SchedulerCapabilities)}
    unknown = set(wanted) - valid
    if unknown:
        raise ValueError(
            f"unknown capability flags {sorted(unknown)}; valid: {sorted(valid)}"
        )
    return [
        spec
        for _, spec in sorted(_REGISTRY.items())
        if all(
            getattr(spec.capabilities, flag) == want
            for flag, want in wanted.items()
        )
    ]


def scheduler_capabilities(scheduler) -> SchedulerCapabilities:
    """Capabilities of a scheduler *instance*; permissive default for
    unregistered third-party schedulers."""
    caps = getattr(scheduler, "capabilities", None)
    if isinstance(caps, SchedulerCapabilities):
        return caps
    return SchedulerCapabilities()
