"""repro_torch: the Steiner solver on PyTorch, with hand-written CUDA kernels.

The PyTorch/CUDA counterpart of the JAX package ``repro``; the two packages
share no code.  This package mirrors its layout and names so that every
module has an obvious counterpart:

core/      graph containers, Voronoi state, distance graph, MST, tree
kernels/   hand-written CUDA C++ kernels for Hopper (sm_90a, built with nvcc
           at first use) beside a plain PyTorch version of each: the
           min-plus ELL relaxation (with a lane axis for query batches) and
           the bucketed segment min
solver/    SolverConfig -> SteinerSolver.prepare(graph or store) -> solve(seeds),
           on one device, a batch, or a torch.distributed mesh of ranks
serve/     query planning, the batched pipeline and the micro-batching
           SteinerServer with its LRU result cache (epoch-aware over a store)
graphstore/ the on-disk ``*.gstore`` CSR layout: ingest, open, views,
           shards, and the CLI ``python -m repro_torch.graphstore``
delta/     edge deltas over a store: the log, its overlay, compaction, warm
           re-solves and the incremental session
obs/       metrics, spans, the Chrome trace recorder and per-round
           telemetry (off until ``obs.enable()``), the per-rank flight
           recorder's analytics, and ``python -m repro_torch.obs``
data/      graph generators and seed selection (numpy-identical to ``repro``)
convert    numpy arrays of the JAX package -> this package's objects

Entry points run on the GPU unless the caller asks for ``device="cpu"``.
A CUDA tensor given to a kernel wrapper launches the kernel or raises; a CPU
tensor takes the plain PyTorch version.  Every single-device schedule of
the reference runs, for ``backend="single"`` and ``backend="batch"``, with
Prim or Borůvka, over an in-memory graph or a graph store with its delta
log; the mesh backends run the paper's distributed engine over
``torch.distributed``.
"""

__version__ = "0.1.0"
