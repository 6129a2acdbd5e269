"""Asynchronous multi-domain PIC engine on one CUDA device (the port of
``repro.distributed``, the paper's §4).

Concept map: the paper's OpenMP/OpenACC and MPI constructs, the
reference's JAX constructs, and the port's.

=====================  ============================  ========================
Paper construct        Reference (JAX)               Port (PyTorch, one card)
=====================  ============================  ========================
MPI rank / subdomain   mesh device under             a domain row r of the
                       ``shard_map``                 (D, ...) tensors
                                                     (``engine.py``)
async(n) queues        interleaved slices of the     the same slices, each
                       (S, cap) buffer, one Python   gathered to a contiguous
                       loop iteration each           buffer; one CUDA stream
                                                     per (domain, queue)
``nowait``             no data edge from queue k's   no event wait between
                       ``ppermute`` to queue k+1's   queue k's copies and
                       push                          queue k+1's push
``depend(in/out)``     packs held as live values     CUDA events: the ring
                       until the deferred merge      and rho chain between
                                                     queues, and the merge's
                                                     wait on every queue
MPI_Isend/Irecv        ``lax.ppermute`` of           device copies of the
                       fixed-size packs              fixed-size packs into
                                                     the neighbour's receive
                                                     rows (``halo.send``)
BIT1 free-slot reuse   ``particles.FreeSlotRing``    the same ring, batched
                       in ``EngineState``            over (D, S), pushed in
                                                     place
MC sources (§3.3/SEE)  per-queue ``ionize_packed``,  the same, between push
                       SEE off the packed absorbed   and exchange; births
                       rows; births pending          pending
Binary collisions      per-queue ``apply_menu``      the same (Coulomb pairs
                                                     through the deflection
                                                     kernel)
OpenMP dynamic         ``rebalance_every`` /         the same; the skew
scheduling             ``rebalance_skew`` under      trigger reads one (G, D)
                       ``lax.cond``                  tensor on the host
MPI_Allgather (field)  eliminated: edge-node         edge-node copies and
                       ``ppermute`` + scalar         (D,) scalar vectors,
                       gathers (``halo.py``)         counted (``halo.py``)
Nsight phase ranges    ``repro.obs.tracing`` scopes  ``obs.tracing``
                                                     ``phase_scope``: a
                                                     ``record_function``
                                                     and an NVTX range with
                                                     the same scope names;
                                                     ``perf.phase_breakdown``
                                                     reads their spans
=====================  ============================  ========================

``core/decomposition.py`` is the back-compat shim over this package
(``DomainConfig`` / ``make_distributed_step`` / ``init_distributed_state``,
async_n = 1).
"""

from repro_torch.distributed.engine import (EngineConfig, EngineState,
                                            attach_engine_state,
                                            init_engine_state,
                                            make_engine_step, retarget_state,
                                            state_from_numpy)
from repro_torch.distributed.perf import (phase_breakdown, queue_stats,
                                          scaling_metrics, write_scaling_json)

__all__ = [
    "EngineConfig", "EngineState", "attach_engine_state",
    "init_engine_state", "make_engine_step", "phase_breakdown",
    "queue_stats", "retarget_state", "scaling_metrics", "state_from_numpy",
    "write_scaling_json",
]
