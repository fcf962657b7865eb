"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

minplus/  the min-plus ELL relaxation of the Voronoi loop: ``minplus_call``
          (distances gathered from the whole table) and
          ``minplus_blocked_call`` (one launch a source slice sized to the
          L2, over a per-graph layout of the adjacency), both in
          ``minplus/csrc/minplus.cu``; each takes (N,) distances or a
          (B, N) batch of query lanes.
segmin/   the bucketed lexicographic segment min ``segmin_bucketed_call``
          (``segmin/csrc/segmin.cu``); no solver path calls it yet.
mst/      Prim's minimum spanning tree, every step in one launch:
          ``prim_call`` (``mst/csrc/prim.cu``), the tail's MST on the card.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version in ``ref.py``.  Sources are compiled with
nvcc at first use (:mod:`repro_torch.kernels._build`).
"""
