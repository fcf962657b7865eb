"""Replica uniformity over the ranks' recordings (SP01–SP03).

The counterpart of ``repro.analysis.spmd.uniformity``.  The lattice value
of a tensor is the set of mesh axes along which it may *vary* per rank;
``frozenset()`` means uniform.  The ranks of one mesh run the same program
on their own shards, so their recordings align op by op: an op's key is
its source line, its name and how often that (line, op) ran before on the
rank.  Seeds and joins:

* a tensor handed to the region varies along the axes the harness
  declares (the edge shard of a rank varies along every axis that splits
  it); any other tensor from outside is uniform;
* an op's outputs vary along the union of its inputs' axes and of the
  axes along which ranks record a different scalar argument or output
  shape for the same op (``seeds >= off`` with ``off`` the rank's block
  base varies along "model"), or along which the op is missing;
* a collective over ``mesh.group(axes)`` that reduces or gathers
  subtracts those axes; a reduce-scatter and an all-to-all leave the
  result varying along them;
* an in-place write joins into the tensors that share the storage (a
  collective's result replaces them).

Checks:

  SP01  a host read (``.tolist()``, ``.item()``, ``bool()``, ``.cpu()`` /
        ``.numpy()`` of an output) of a value that varies along a mesh
        axis: ranks disagree on a flag that steers their loop
        (``core/dist_steiner.py``'s round flag) or return different
        "replicated" outputs.
  SP02  a collective over a group that is none of the mesh's
        ``group(axes)``.
  SP03  the ranks of one group record different collective sequences
        (kind, group, size): a real mesh deadlocks.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.spmd.dispatch_tools import OpRecord, Recording, Violation

Axes = frozenset
_EMPTY: Axes = frozenset()
# collective kinds whose result is the same on every rank of the group
_UNIFORM_RESULT = frozenset({"all-reduce", "all-gather"})

Key = Tuple[str, int, str, int]


def op_keys(rec: Recording) -> List[Key]:
    """The alignment key of each op: (path, line, op, occurrence)."""
    seen: Dict[Tuple[str, int, str], int] = {}
    out = []
    for op in rec.ops:
        k = (op.path, op.line, op.op)
        n = seen.get(k, 0)
        seen[k] = n + 1
        out.append((*k, n))
    return out


def _varying_axes(values: Dict[int, object], recs: Sequence[Recording]) -> Axes:
    """Mesh axes along which ``values`` (rank -> value) differ: two ranks
    whose coordinates differ only on that axis hold different values."""
    axes = recs[0].axes
    coords = {r.rank: r.coords for r in recs}
    out = set()
    ranks = sorted(values)
    for i, a in enumerate(ranks):
        for b in ranks[i + 1:]:
            diff = [x for x in axes if coords[a][x] != coords[b][x]]
            if len(diff) == 1 and values[a] != values[b]:
                out.add(diff[0])
    return frozenset(out)


def _signature(op: OpRecord, rec: Recording):
    shapes = tuple(rec.tensors[t].shape for t in op.outputs)
    return (op.scalars(), shapes)


class Lattice:
    """The uniformity dataflow over the aligned recordings of every rank."""

    def __init__(self, recs: Sequence[Recording]):
        self.recs = sorted(recs, key=lambda r: r.rank)
        self.axes = frozenset(self.recs[0].axes)
        self.keys = {r.rank: op_keys(r) for r in self.recs}
        by_key: Dict[Key, Dict[int, OpRecord]] = {}
        for r in self.recs:
            for k, op in zip(self.keys[r.rank], r.ops):
                by_key.setdefault(k, {})[r.rank] = op
        self.extra: Dict[Key, Axes] = {}
        all_ranks = [r.rank for r in self.recs]
        recmap = {r.rank: r for r in self.recs}
        for k, ops in by_key.items():
            sig = {rank: _signature(op, recmap[rank]) for rank, op in ops.items()}
            present = {rank: rank in ops for rank in all_ranks}
            self.extra[k] = _varying_axes(sig, self.recs) | _varying_axes(present, self.recs)

    def run(self, out: Optional[List[Violation]] = None) -> Dict[Key, Axes]:
        """Runs the dataflow on every rank; returns key -> the union over
        ranks of the axes the op's result (its writes, else its outputs)
        varies along."""
        verdict: Dict[Key, Axes] = {}
        for rec in self.recs:
            for k, axes in zip(self.keys[rec.rank], self._rank(rec, out)):
                verdict[k] = verdict.get(k, _EMPTY) | axes
        return verdict

    def _rank(self, rec: Recording, out: Optional[List[Violation]]) -> List[Axes]:
        state: Dict[int, Axes] = {}  # tensor key -> axes
        by_storage: Dict[int, List[int]] = {}
        for t, info in rec.tensors.items():
            by_storage.setdefault(info.storage, []).append(t)
        declared = {s: frozenset(a) & self.axes for s, a in rec.inputs.items()}

        def get(t: int) -> Axes:
            if t not in state:
                state[t] = declared.get(rec.tensors[t].storage, _EMPTY)
            return state[t]

        results = []
        for k, op in zip(self.keys[rec.rank], rec.ops):
            ins = frozenset().union(*(get(t) for t in op.inputs)) if op.inputs else _EMPTY
            if op.host_read:
                if out is not None and ins & self.axes:
                    out.append(Violation(
                        "SP01",
                        f"host read of a value that varies along mesh axis(es) "
                        f"{sorted(ins & self.axes)}: ranks disagree on it (a loop flag "
                        "steers them apart, an output is not replicated); reduce it over "
                        "the group first", op))
                results.append(ins)
                continue
            if op.collective is not None:
                kind, ranks = op.collective
                group_axes = rec.mesh_groups.get(ranks)
                ga = frozenset(group_axes or ())
                if group_axes is None:
                    if out is not None:
                        out.append(Violation(
                            "SP02",
                            f"{kind} over ranks {list(ranks)}, a group that is none of the "
                            f"mesh's group(axes) (axes {sorted(self.axes)}): the "
                            "reduction does not cover the axis it was meant to", op))
                    res = ins
                elif kind in _UNIFORM_RESULT:
                    res = ins - ga
                else:
                    res = ins | ga
                for w in op.writes:
                    for u in by_storage[rec.tensors[w].storage]:
                        state[u] = res if u == w else (get(u) - ga) | res
                for o in op.outputs:
                    if o not in op.writes:
                        state[o] = res
                results.append(res)
                continue
            res = ins | self.extra[k]
            for w in op.writes:
                for u in by_storage[rec.tensors[w].storage]:
                    state[u] = get(u) | res
            for o in op.outputs:
                if o not in op.writes:
                    state[o] = res
            results.append(res)
        return results


def check_sequences(recs: Sequence[Recording]) -> List[Violation]:
    """SP03: every rank of a group records the same collectives over it."""
    out: List[Violation] = []
    seqs: Dict[Tuple[int, ...], Dict[int, List[Tuple[tuple, OpRecord]]]] = {}
    for rec in recs:
        for op in rec.ops:
            if op.collective is None:
                continue
            kind, ranks = op.collective
            size = tuple(rec.tensors[t].shape for t in op.inputs)
            seqs.setdefault(ranks, {}).setdefault(rec.rank, []).append(((kind, size), op))
    for ranks, per_rank in sorted(seqs.items()):
        members = [r for r in ranks if any(rec.rank == r for rec in recs)]
        lists = {r: per_rank.get(r, []) for r in members}
        longest = max(len(v) for v in lists.values())
        for i in range(longest):
            sigs = {r: (v[i][0] if i < len(v) else None) for r, v in lists.items()}
            if len(set(sigs.values())) > 1:
                op = next(v[i][1] for v in lists.values() if i < len(v))
                out.append(Violation(
                    "SP03",
                    f"the ranks {list(ranks)} of one group record different collective "
                    f"sequences at its collective #{i} ({sigs}): a real mesh deadlocks "
                    "or pairs mismatched participants", op))
                break
    return out


def analyze(recs: Sequence[Recording]) -> List[Violation]:
    """SP01–SP03 over the recordings of one mesh's ranks (nothing for a
    run without a mesh: it has no replica structure to violate)."""
    if not recs or not recs[0].mesh_dims:
        return []
    out: List[Violation] = []
    Lattice(recs).run(out)
    return out + check_sequences(recs)
