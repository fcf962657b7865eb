"""repro_torch: the Steiner solver on PyTorch, with hand-written CUDA kernels,
and the reference's model substrate (the LM trainer, the GNN family, MIND).

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
data/      graph generators, seed selection and neighbour sampling, the
           synthetic token and behaviour streams (numpy-identical to
           ``repro``)
configs/   the architecture registry (``get_arch``: the eleven archs' configs
           and shape cells) and the Steiner solver presets
models/    the LM family: RMSNorm, interleaved RoPE, chunked online-softmax
           GQA and MLA attention, int8 KV cache, SwiGLU and the MoE FFN;
           the transformer over stacked layer parameters with its train,
           decode and prefill steps; the GNN family (GraphSAGE, GatedGCN,
           SchNet, GraphCast) and the MIND recommender
optim/     AdamW with fp32 or 8-bit block-quantized moments, updated in place,
           and ``opt_state_specs``
distributed/ sharding rules over DTensor (``P``, ``sanitize_spec``,
           ``named_sharding``, ``constrain``, ``local_call``) and int8
           gradient compression with error feedback
checkpoint/ npz checkpoints in the reference's format (either package
           restores the other's), async and rolling, with elastic restore
           onto a mesh (``shardings=``)
launch/    the fault-tolerant training loop ``python -m
           repro_torch.launch.train`` and the production and test
           ``DeviceMesh``es (``launch/mesh.py``)
analysis/  the jitlint trace-safety analyzer: sync-free regions and rules
           TS01–TS07 over the source (no torch import), recorded-op SPMD,
           range and ownership rules SP01–SP03 / NU01–NU02 / DN01, the
           runtime sanitizer; ``python -m repro_torch.analysis``
knobs      which SolverConfig fields fix a memoized view (TS06), the
           ``sync_free`` marker, and the memo-miss counters
tree       nested dicts of tensors (the reference's pytrees)
convert    numpy arrays of the JAX package -> this package's objects (graphs,
           Voronoi state, LM, GNN and MIND parameters, optimizer state)

Entry points run on the GPU unless the caller asks for ``device="cpu"``.
A CUDA tensor given to a kernel wrapper launches the kernel or raises; a CPU
tensor takes the plain PyTorch version.  Every single-device schedule of
the reference runs, for ``backend="single"`` and ``backend="batch"``, with
Prim or Borůvka, over an in-memory graph or a graph store with its delta
log; the mesh backends run the paper's distributed engine over
``torch.distributed``.  The model stacks have no kernel of their own: the
reference's transformer, GNNs and MIND are plain XLA, and their port
plain PyTorch.  Their train steps also run SPMD on a ``DeviceMesh`` of
``torch.distributed`` ranks: parameters, moments and inputs as DTensors
placed by each family's specs, one rank a card over NCCL or a CPU process
over gloo.
"""

__version__ = "0.1.0"
