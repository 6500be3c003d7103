"""Per-architecture distribution plans: how an arch factors the pinned
physical production mesh into the logical HFL training mesh (copy of
``src/repro/sharding/plan.py``).

The physical meshes are fixed (``launch/mesh.py``):
    single-pod : (16, 16)        axes ("data", "model")
    multi-pod  : (2, 16, 16)     axes ("pod", "data", "model")

Training re-factors the same 256/512 ranks into the logical axes

    (group, client, fsdp, model)   with  G*K*F*M == #chips

* ``group``/``client`` carry the paper's HFL topology: MTGC's group
  aggregation is an all-reduce over ``client``; global aggregation is an
  all-reduce over ``group`` (x ``pod`` in the multi-pod case -- pods are
  groups, so inter-group non-i.i.d. rides the slow inter-pod links).
* ``fsdp`` ZeRO-3-shards each client's replica; ``model`` is Megatron-style
  tensor parallelism. Both are *inside* a client submesh.

Serving uses the physical ("data", "model") axes directly (no FL topology).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """How one architecture maps onto the production meshes.

    train_factors: (G, K, F, M) for the 256-chip pod. On the 2-pod mesh the
        pod axis multiplies G (2 pods => 2*G groups).
    microbatch:    per-device microbatch for train_4k (grad-accumulated over
        the per-client batch 256/(G*K) split across F).
    dryrun_E/H:    group rounds / local steps of the dry-run round.
    """

    train_factors: tuple[int, int, int, int] = (4, 4, 1, 16)
    microbatch: int = 4
    dryrun_E: int = 2
    dryrun_H: int = 2

    def validate(self, chips: int = 256) -> "MeshPlan":
        g, k, f, m = self.train_factors
        assert g * k * f * m == chips, (self.train_factors, chips)
        return self

    @property
    def clients(self) -> int:
        g, k, _, _ = self.train_factors
        return g * k
