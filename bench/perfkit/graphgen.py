"""The benchmark's graph, made on the device from ``--seed``.

A Graph500-style Kronecker (RMAT) generator with the structure of the
repo's ``RmatEdgeSource``: ``n = 2**scale`` vertices, ``edge_factor * n``
undirected edges drawn quadrant by quadrant with probabilities (a, b, c,
1 - a - b - c), a random relabelling of the vertex ids, self-loops dropped,
integer weights uniform in [1, max_weight], and a random path through every
vertex so that the graph is one component.  Its random numbers come from a
``torch.Generator`` on the device, in a few large calls, so a full-width
graph (1.5e8 directed edges) takes about a second on the card where the
numpy generator takes about twenty on its host.  It is the benchmark's own
copy: the same seed gives the same graph on the same device.

A configuration whose ``graph`` names a ``structure_seed`` gets one graph
for every run: drawn from that seed, then relabelled by a permutation drawn
from the run's seed.  Every run then does the same work in another vertex
order, where a graph of its own would change the work (the mesh solver's
rounds follow the graph's farthest vertices, not the query).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CHUNK = 1 << 24  # edges drawn a call


@dataclasses.dataclass(frozen=True)
class Edges:
    """Undirected edges, one direction each, on the device they were made on."""

    src: torch.Tensor  # (m,) int32
    dst: torch.Tensor  # (m,) int32
    w: torch.Tensor  # (m,) float32, integers in [1, max_weight]
    n: int

    @property
    def directed_edges(self) -> int:
        """Edges of the symmetric graph the program is given (padding excluded)."""
        return 2 * int(self.src.shape[0])

    def symmetric(self, device=None):
        """(src, dst, w) of both directions, int64 ids, on ``device``."""
        dev = self.src.device if device is None else device
        src = self.src.to(dev, torch.int64)
        dst = self.dst.to(dev, torch.int64)
        w = self.w.to(dev)
        return torch.cat([src, dst]), torch.cat([dst, src]), torch.cat([w, w])

    def to(self, device) -> "Edges":
        return Edges(self.src.to(device), self.dst.to(device), self.w.to(device), self.n)


def torch_seed(seed: int, purpose: int) -> int:
    """A 63-bit generator seed for one purpose, from the run's seed."""
    return int(np.random.SeedSequence([seed, purpose]).generate_state(1, np.uint64)[0] >> 1)


def rmat(spec: dict, seed: int, device) -> Edges:
    """The RMAT graph of a configuration's ``graph`` entry."""
    if spec.get("generator") != "rmat":
        raise ValueError(f"unknown graph generator {spec.get('generator')!r}")
    scale, a, b, c = int(spec["scale"]), float(spec["a"]), float(spec["b"]), float(spec["c"])
    if not (0 < a and 0 <= b and 0 <= c and a + b + c < 1):
        raise ValueError(f"bad RMAT probabilities a={a} b={b} c={c}")
    n = 1 << scale
    m = int(spec["edge_factor"]) * n
    max_w = int(spec["max_weight"])
    structure = spec.get("structure_seed")
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed if structure is None else int(structure), 0))
    perm = torch.randperm(n, generator=gen, device=device).to(torch.int32)
    srcs, dsts = [], []
    for lo in range(0, m, CHUNK):
        k = min(CHUNK, m - lo)
        s = torch.zeros(k, dtype=torch.int32, device=device)
        d = torch.zeros(k, dtype=torch.int32, device=device)
        for lvl in range(scale):
            r = torch.rand(k, generator=gen, device=device)
            # quadrants a | b / c | d: the source bit is set in c and d,
            # the destination bit in b and d
            s |= (r >= a + b).to(torch.int32) << lvl
            d |= (((r >= a) & (r < a + b)) | (r >= a + b + c)).to(torch.int32) << lvl
        s, d = perm[s.long()], perm[d.long()]
        keep = s != d
        srcs.append(s[keep])
        dsts.append(d[keep])
    # a path through every vertex keeps the graph one component
    path = torch.randperm(n, generator=gen, device=device).to(torch.int32)
    srcs.append(path[:-1])
    dsts.append(path[1:])
    src, dst = torch.cat(srcs), torch.cat(dsts)
    w = torch.randint(1, max_w + 1, (src.shape[0],), generator=gen, device=device)
    if structure is not None:
        gen.manual_seed(torch_seed(seed, 0))
        relabel = torch.randperm(n, generator=gen, device=device).to(torch.int32)
        src, dst = relabel[src.long()], relabel[dst.long()]
    return Edges(src=src, dst=dst, w=w.to(torch.float32), n=n)
