"""Fleet placement: seat camera streams onto data shards (a copy of the
reference's ``repro/batched/fleet.py``; pure Python on the shared
``LadderCostModel``).  The scheduler seats through the placer and
rebalances with it when its engines have more than one shard
(``mesh=``); at one shard it keeps only the dead set of
``kill_shard``/``revive_shard``.

On a mesh of devices, every rung engine's padded slot batch is
partitioned into contiguous per-shard slot blocks
(``distributed.sharding.slot_batch_spec``) — one block per device.  A
shard's tick cost grows with *its own* served count (each device runs
the step over its slice in parallel; the tick is as slow as its slowest
shard), so where a joining stream sits determines the whole bucket's
latency tail.

:class:`FleetPlacer` makes that seat choice with the same shared
:class:`~repro_torch.anytime.cost.LadderCostModel` the contract controllers
predict with: the candidate shard is the one whose *post-seating*
predicted (rung, batch-size) cost is smallest — which degrades
gracefully to least-occupied placement while the model is still on its
prior (cost is monotone in batch size), and stays consistent with the
controller's deadline reasoning once the regression has data.

:meth:`FleetPlacer.rebalance` is the skew repair: when one shard's
occupancy exceeds another's by more than one stream, serving cost is
paid at the crowded shard's batch size while the idle shard's slots do
nothing — migrating one stream strictly lowers the max-over-shards tick
cost.  The scheduler applies it between ticks (slot churn only; captured
shapes never change, so migration never captures anew).
"""
from __future__ import annotations

from typing import Optional

from ..anytime.cost import LadderCostModel, SceneFeatures

__all__ = ["FleetPlacer"]


class FleetPlacer:
    """Predicted-cost seat (and re-seat) choice over ``n_shards`` data
    shards.  Stateless beyond its model handle: occupancy is passed in
    per call, so one placer serves every rung engine."""

    def __init__(self, cost: LadderCostModel, n_shards: int,
                 pipeline_depth: int = 1) -> None:
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1 (got {n_shards})")
        self.cost = cost
        self.n_shards = n_shards
        self.pipeline_depth = pipeline_depth
        # shards declared lost by the chaos/recovery path: excluded from
        # placement and rebalance until revived.  Their slots still exist
        # in every engine's padded batch (the captured shape is sacred) —
        # "dead" only means no stream may be seated there.
        self.dead: set[int] = set()

    def mark_dead(self, shard: int) -> None:
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range [0, {self.n_shards})")
        self.dead.add(shard)

    def mark_alive(self, shard: int) -> None:
        self.dead.discard(shard)

    def _shard_cost(self, rung_name: str, batch_size: int) -> float:
        """Predicted batched-step cost of one shard serving
        ``batch_size`` streams of ``rung_name`` (mean + a std term so
        high-variance rungs prefer emptier shards earlier)."""
        if batch_size <= 0:
            return 0.0
        p = self.cost.predict(rung_name, SceneFeatures(
            batch_size=float(batch_size), batched=True,
            pipeline_depth=float(self.pipeline_depth)))
        return p.mean + p.std

    def place(self, rung_name: str, occupancy: list[int],
              slots_per_shard: int) -> int:
        """Shard index for a joining ``rung_name`` stream.

        Picks the shard whose predicted cost *after* seating the stream
        is smallest among shards with a free slot (ties -> lower index,
        so placement is deterministic under replay).  Raises when every
        shard is full."""
        if len(occupancy) != self.n_shards:
            raise ValueError(
                f"occupancy has {len(occupancy)} entries for "
                f"{self.n_shards} shards")
        candidates = [k for k in range(self.n_shards)
                      if occupancy[k] < slots_per_shard and k not in self.dead]
        if not candidates:
            alive = self.n_shards - len(self.dead)
            raise RuntimeError(
                f"all {alive} alive shards full "
                f"({slots_per_shard} slots each, "
                f"{len(self.dead)} shard(s) dead)")
        return min(candidates,
                   key=lambda k: (self._shard_cost(rung_name,
                                                   occupancy[k] + 1), k))

    def rebalance(self, rung_name: str, occupancy: list[int],
                  ) -> Optional[tuple[int, int]]:
        """One migration ``(src_shard, dst_shard)`` when occupancy skew
        makes it worthwhile, else ``None``.

        Skew of one stream is the steady state of balanced churn and
        never worth a carve-out; from two upward, moving a stream off
        the most-loaded shard strictly reduces the max per-shard batch
        size this rung pays every tick."""
        alive = [k for k in range(self.n_shards) if k not in self.dead]
        if len(alive) <= 1:
            return None
        src = max(alive, key=lambda k: (occupancy[k], -k))
        dst = min(alive, key=lambda k: (occupancy[k], k))
        if occupancy[src] - occupancy[dst] < 2:
            return None
        return (src, dst)
