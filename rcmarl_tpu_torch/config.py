"""Experiment configuration: the port's own copy of ``rcmarl_tpu/config.py``.

:class:`Config` has every field of the JAX package's ``Config``, with
the same names and defaults, so that the ``__config__`` JSON header a
checkpoint carries decodes here and a checkpoint written here carries a
byte-identical header. The validation is the JAX package's, minus the
graph-schedule helpers that only the training slices use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from rcmarl_tpu_torch.faults import FaultPlan, ReplicaFaultPlan

#: Valid ``consensus_impl`` names of the JAX package (recorded verbatim
#: in checkpoints; the serve slice runs no consensus).
CONSENSUS_IMPLS = (
    "xla",
    "xla_sort",
    "pallas",
    "pallas_sort",
    "pallas_interpret",
    "pallas_fused",
    "pallas_fused_interpret",
    "auto",
)
FUSED_CONSENSUS_IMPLS = ("pallas_fused", "pallas_fused_interpret")
FITSTACK_IMPLS = ("pallas", "pallas_interpret")
ENV_NAMES = ("grid_world", "pursuit", "coverage", "congestion")
GRAPH_SCHEDULES = ("static", "random_geometric")
DENSE_DEGREE_LIMIT = 64
GOSSIP_GRAPHS = ("ring", "full", "random_geometric")
GOSSIP_MIXES = ("trimmed", "mean")


class Roles:
    """Integer role codes of the agent behaviours."""

    COOPERATIVE = 0
    GREEDY = 1
    FAULTY = 2
    MALICIOUS = 3
    ADAPTIVE = 4


def circulant_in_nodes(n_agents: int, degree: int) -> Tuple[Tuple[int, ...], ...]:
    """Directed circulant graph, self first: agent i hears
    ``(i, i+1, ..., i+degree-1) mod n``."""
    if not 1 <= degree <= n_agents:
        raise ValueError(f"degree must be in [1, {n_agents}], got {degree}")
    return tuple(
        tuple((i + k) % n_agents for k in range(degree)) for i in range(n_agents)
    )


@dataclass(frozen=True)
class Config:
    """Hyperparameters; field for field the JAX package's ``Config``."""

    # --- topology / cast ---
    n_agents: int = 5
    agent_roles: Tuple[int, ...] = (Roles.COOPERATIVE,) * 5
    in_nodes: Tuple[Tuple[int, ...], ...] = circulant_in_nodes(5, 4)
    # --- spaces ---
    n_actions: int = 5
    n_states: int = 2
    nrow: int = 5
    ncol: int = 5
    # --- schedule ---
    n_episodes: int = 7000
    max_ep_len: int = 20
    n_ep_fixed: int = 50
    n_epochs: int = 10
    # --- optimization ---
    slow_lr: float = 0.01
    fast_lr: float = 0.01
    batch_size: int = 200
    buffer_size: int = 2000
    gamma: float = 0.9
    # --- resilience ---
    H: int = 0
    common_reward: bool = False
    eps_explore: float = 0.1
    # --- model ---
    hidden: Tuple[int, ...] = (20, 20)
    leaky_alpha: float = 0.1
    # --- environment ---
    env: str = "grid_world"
    collision_physics: bool = False
    scaling: bool = True
    randomize_state: bool = True
    congestion_weight: float = 1.0
    # --- time-varying communication graphs ---
    graph_schedule: str = "static"
    graph_every: int = 1
    graph_degree: int = 0
    graph_seed: int = 0
    # --- adaptive adversary ---
    adaptive_scale: float = 10.0
    reference_clip: bool = False
    # --- adversary / cooperative fit schedules ---
    adv_fit_epochs: int = 10
    adv_fit_batch: int = 32
    coop_fit_steps: int = 5
    fit_clip: float = 0.0
    seed: int = 300
    # --- consensus / stacking arms (recorded; the serve slice runs none) ---
    consensus_impl: str = "xla"
    consensus_layout: str = "flat"
    netstack: "bool | str" = "auto"
    fitstack: "bool | str" = "auto"
    # --- transport faults ---
    fault_plan: Optional[FaultPlan] = None
    consensus_sanitize: bool = False
    # --- gossip replicas ---
    replicas: int = 0
    gossip_every: int = 1
    gossip_graph: str = "ring"
    gossip_degree: int = 3
    gossip_H: int = 1
    gossip_mix: str = "trimmed"
    gossip_seed: int = 0
    replica_fault_plan: Optional[ReplicaFaultPlan] = None
    # --- Diff-DAC task axis ---
    task_axis: bool = False
    task_levels: Tuple[float, ...] = ()
    # --- async pipeline ---
    pipeline_depth: int = 0
    publish_every: int = 1
    canary_band: float = 0.0
    canary_blocks: int = 1
    # --- matmul precision: 'float32' exact, 'bfloat16' operands with
    # float32 accumulation ---
    compute_dtype: str = "float32"

    def __post_init__(self):
        self._check_graph()
        self._check_knobs()
        self._check_replicas()

    def _check_graph(self) -> None:
        if len(self.agent_roles) != self.n_agents:
            raise ValueError("agent_roles length must equal n_agents")
        if len(self.in_nodes) != self.n_agents:
            raise ValueError("in_nodes length must equal n_agents")
        for i, nbrs in enumerate(self.in_nodes):
            if nbrs[0] != i:
                raise ValueError(f"in_nodes[{i}] must list the agent itself first")
            if not 0 <= 2 * self.H <= len(nbrs) - 1:
                raise ValueError(
                    f"H={self.H} too large for in_nodes[{i}] of degree "
                    f"{len(nbrs)}: need 2H <= degree-1"
                )
        if self.graph_schedule not in GRAPH_SCHEDULES:
            raise ValueError(
                f"graph_schedule={self.graph_schedule!r}: expected one of "
                f"{GRAPH_SCHEDULES}"
            )
        if self.graph_every < 1:
            raise ValueError(f"graph_every={self.graph_every} must be >= 1")
        if not 0 <= self.graph_degree <= self.n_agents:
            raise ValueError(
                f"graph_degree={self.graph_degree} must be in "
                f"[0, n_agents={self.n_agents}]"
            )
        if self.graph_schedule != "static":
            deg = self.resolved_graph_degree
            if not 0 <= 2 * self.H <= deg - 1:
                raise ValueError(
                    f"H={self.H} too large for a resampled graph of in-degree {deg}"
                )
            if self.replicas or self.pipeline_depth:
                raise ValueError(
                    "graph_schedule='random_geometric' is a solo-trainer "
                    "feature; run with replicas=0 and pipeline_depth=0"
                )
        if self.graph_schedule == "static" and self.n_in > DENSE_DEGREE_LIMIT:
            raise ValueError(
                f"static in-neighborhoods of degree {self.n_in} exceed "
                f"DENSE_DEGREE_LIMIT={DENSE_DEGREE_LIMIT}"
            )

    def _check_knobs(self) -> None:
        if self.env not in ENV_NAMES:
            raise ValueError(f"env={self.env!r}: expected one of {ENV_NAMES}")
        if self.env != "grid_world" and (self.collision_physics or self.reference_clip):
            raise ValueError(
                "collision_physics/reference_clip are grid_world-only knobs"
            )
        for name in ("adaptive_scale", "congestion_weight", "fit_clip"):
            if not float(getattr(self, name)) >= 0.0:
                raise ValueError(f"{name}={getattr(self, name)} must be >= 0")
        if self.task_levels and not self.task_axis:
            raise ValueError("task_levels needs task_axis=True")
        if self.task_axis:
            if self.replicas < 2:
                raise ValueError("task_axis=True needs replicas >= 2")
            if self.env != "congestion":
                raise ValueError("task_axis=True needs env='congestion'")
            if self.pipeline_depth:
                raise ValueError("task_axis=True excludes pipeline_depth > 0")
            if self.task_levels and len(self.task_levels) != self.replicas:
                raise ValueError("task_levels needs one level per replica")
            if self.task_levels and not all(float(l) > 0.0 for l in self.task_levels):
                raise ValueError(f"task_levels={self.task_levels} must all be > 0")
            if Roles.ADAPTIVE in self.agent_roles:
                raise ValueError("task_axis=True does not model ADAPTIVE agents")
            if self.consensus_impl not in ("xla", "xla_sort", "auto"):
                raise ValueError(
                    f"task_axis=True excludes consensus_impl={self.consensus_impl!r}"
                )
        if self.consensus_impl not in CONSENSUS_IMPLS:
            raise ValueError(
                f"consensus_impl={self.consensus_impl!r}: expected one of "
                f"{CONSENSUS_IMPLS}"
            )
        if self.consensus_layout not in ("flat", "per_leaf"):
            raise ValueError(
                f"consensus_layout={self.consensus_layout!r}: expected "
                "'flat' or 'per_leaf'"
            )
        if not (isinstance(self.netstack, bool) or self.netstack == "auto"):
            raise ValueError(f"netstack={self.netstack!r}: expected a bool or 'auto'")
        if not (
            isinstance(self.fitstack, bool)
            or self.fitstack == "auto"
            or self.fitstack in FITSTACK_IMPLS
        ):
            raise ValueError(
                f"fitstack={self.fitstack!r}: expected a bool, 'auto' or one "
                f"of {FITSTACK_IMPLS}"
            )
        if self.consensus_impl in FUSED_CONSENSUS_IMPLS and self.netstack is False:
            raise ValueError(
                f"consensus_impl={self.consensus_impl!r} needs the stacked "
                "layout; netstack=False contradicts it"
            )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype={self.compute_dtype!r}: expected 'float32' or "
                "'bfloat16'"
            )
        if self.fault_plan is not None and not isinstance(self.fault_plan, FaultPlan):
            raise ValueError(
                f"fault_plan must be a FaultPlan (got {type(self.fault_plan).__name__})"
            )
        if self.pipeline_depth < 0:
            raise ValueError(f"pipeline_depth={self.pipeline_depth} must be >= 0")
        if self.publish_every < 1:
            raise ValueError(f"publish_every={self.publish_every} must be >= 1")

    def _check_replicas(self) -> None:
        if self.replicas < 0:
            raise ValueError(f"replicas={self.replicas} must be >= 0")
        if self.canary_band < 0:
            raise ValueError(f"canary_band={self.canary_band} must be >= 0")
        if self.canary_blocks < 1:
            raise ValueError(f"canary_blocks={self.canary_blocks} must be >= 1")
        if self.canary_band and not (self.replicas and self.pipeline_depth):
            raise ValueError(
                "canary_band needs replicas > 0 AND pipeline_depth > 0"
            )
        if self.replicas and self.pipeline_depth and self.gossip_every:
            if self.pipeline_depth > self.gossip_every:
                raise ValueError(
                    f"pipeline_depth={self.pipeline_depth} > "
                    f"gossip_every={self.gossip_every}"
                )
        if self.gossip_every < 0:
            raise ValueError(f"gossip_every={self.gossip_every} must be >= 0")
        if self.gossip_graph not in GOSSIP_GRAPHS:
            raise ValueError(
                f"gossip_graph={self.gossip_graph!r}: expected one of {GOSSIP_GRAPHS}"
            )
        if self.gossip_mix not in GOSSIP_MIXES:
            raise ValueError(
                f"gossip_mix={self.gossip_mix!r}: expected one of {GOSSIP_MIXES}"
            )
        if self.replica_fault_plan is not None and not isinstance(
            self.replica_fault_plan, ReplicaFaultPlan
        ):
            raise ValueError("replica_fault_plan must be a ReplicaFaultPlan")
        if self.replicas:
            if self.gossip_graph != "full" and not (
                1 <= self.gossip_degree <= self.replicas
            ):
                raise ValueError(
                    f"gossip_degree={self.gossip_degree} must be in "
                    f"[1, replicas={self.replicas}]"
                )
            if not 0 <= 2 * self.gossip_H <= self.gossip_n_in - 1:
                raise ValueError(
                    f"gossip_H={self.gossip_H} too large for in-degree "
                    f"{self.gossip_n_in}"
                )
            if self.replica_fault_plan is not None:
                bad = [
                    b
                    for b in self.replica_fault_plan.byzantine_replicas
                    if b >= self.replicas
                ]
                if bad:
                    raise ValueError(
                        f"replica_fault_plan.byzantine_replicas={bad} out of "
                        f"range for replicas={self.replicas}"
                    )

    # ---- derived quantities ----

    @property
    def n_in(self) -> int:
        return max(len(nbrs) for nbrs in self.in_nodes)

    @property
    def resolved_graph_degree(self) -> int:
        return self.graph_degree if self.graph_degree else self.n_in

    @property
    def gossip_n_in(self) -> int:
        return self.replicas if self.gossip_graph == "full" else self.gossip_degree

    @property
    def dot_dtype(self) -> "str | None":
        """Matmul compute dtype for :func:`rcmarl_tpu_torch.models.mlp.dot`:
        ``None`` = exact float32, ``'bfloat16'`` = bf16 operands with
        float32 accumulation."""
        return "bfloat16" if self.compute_dtype == "bfloat16" else None

    @property
    def obs_dim(self) -> int:
        """Flattened global-state input dim of actor/critic (N * n_states)."""
        return self.n_agents * self.n_states

    @property
    def sa_dim(self) -> int:
        """Flattened state-action input dim of the team-reward net."""
        return self.n_agents * (self.n_states + 1)
