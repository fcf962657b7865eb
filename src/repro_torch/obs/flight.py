"""Flight-recorder analytics over per-rank solve telemetry.

The paper's §VI evaluation is phrased in *per-rank* measurements —
message counts, relaxation load, straggler behavior across MPI
processes.  A mesh solve run with ``SolverConfig.telemetry_per_rank=True``
carries the same measurements out of the fixpoint loop as a
``(rounds, n_ranks, 4)`` buffer (``SolveTelemetry.per_rank``, channel
order :data:`repro_torch.obs.ROUND_CHANNELS`); this module turns that buffer
into the numbers an operator acts on:

  * per-round **load-imbalance factor** — max/mean over ranks, the
    classic metric (1.0 = perfectly balanced; R = one rank does all the
    work);
  * **straggler identification** — which rank carries the round maximum,
    and how often;
  * **message skew** — the rank-total spread of the messages channel;
  * **ghost-corrected rank totals** that sum exactly to the global
    channels (the engines subtract each block's padding rows in-loop,
    so consistency is bit-exact for integer-valued f32 counts).

A copy of ``repro.obs.flight`` (numpy and the standard library only), so
a report renders the same from either package's buffers, and on a machine
with no accelerator stack from a dumped flight file.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from . import ROUND_CHANNELS

MSG = ROUND_CHANNELS.index("messages")


@dataclasses.dataclass(frozen=True)
class FlightReport:
    """Digested view of one solve's per-rank flight recording.

    Attributes:
      label: free-form origin tag (``backend/mode``, bench row name...).
      rounds: recorded rounds R (min(iterations, telemetry_rounds)).
      n_ranks: mesh devices (mesh1d: replica*blocks; mesh2d: R*C).
      channels: channel names, ROUND_CHANNELS order.
      rank_totals: (n_ranks, 4) per-rank channel totals over all rounds.
      global_totals: (4,) channel totals (= rank_totals summed).
      imbalance: (R, 4) per-round max/mean load-imbalance factor per
        channel; 1.0 where the round's channel is all-zero.
      mean_imbalance: (4,) imbalance averaged over rounds with activity.
      peak_imbalance: (4,) worst round per channel.
      message_skew: max/mean of the per-rank message totals.
      stragglers: ranks ordered by how many rounds they carried the
        per-round message maximum, as (rank, rounds_at_max) pairs —
        first entry is *the* straggler.
    """

    label: str
    rounds: int
    n_ranks: int
    channels: Tuple[str, ...]
    rank_totals: np.ndarray
    global_totals: np.ndarray
    imbalance: np.ndarray
    mean_imbalance: np.ndarray
    peak_imbalance: np.ndarray
    message_skew: float
    stragglers: Tuple[Tuple[int, int], ...]


def _as_per_rank(per_rank) -> np.ndarray:
    arr = np.asarray(per_rank, np.float64)
    if arr.ndim != 3 or arr.shape[2] != len(ROUND_CHANNELS):
        raise ValueError(
            f"per_rank must be (rounds, n_ranks, {len(ROUND_CHANNELS)}), "
            f"got shape {arr.shape}"
        )
    return arr


def load_imbalance(per_rank) -> np.ndarray:
    """(R, 4) per-round max/mean imbalance factor for every channel.

    Rounds where a channel is identically zero (no work anywhere) report
    1.0 — balanced by definition, not a division error.
    """
    arr = _as_per_rank(per_rank)
    mx = arr.max(axis=1)
    mean = arr.mean(axis=1)
    return np.where(mean > 0, mx / np.where(mean > 0, mean, 1.0), 1.0)


def straggler_ranks(
    per_rank, channel: int = MSG
) -> Tuple[Tuple[int, int], ...]:
    """Ranks ranked by rounds spent carrying the per-round channel max.

    Only rounds with any activity in the channel count; ties on a round
    go to every tied rank.  Returns ((rank, rounds_at_max), ...) sorted
    by rounds_at_max descending (rank ascending on ties), zero-count
    ranks omitted.
    """
    arr = _as_per_rank(per_rank)[:, :, channel]
    active = arr.max(axis=1) > 0
    counts = np.zeros(arr.shape[1], np.int64)
    if active.any():
        act = arr[active]
        at_max = act == act.max(axis=1, keepdims=True)
        counts = at_max.sum(axis=0).astype(np.int64)
    order = sorted(
        (int(r) for r in np.nonzero(counts)[0]),
        key=lambda r: (-int(counts[r]), r),
    )
    return tuple((r, int(counts[r])) for r in order)


def check_consistency(per_rank, per_round, *, label: str = "") -> None:
    """Asserts the flight recording sums exactly to the global channels.

    The engines attribute replica-uniform block channels to one rank and
    subtract ghost padding per block, so for integer-valued f32 counts
    the per-round rank sums must equal ``per_round`` bit-for-bit.
    Raises ValueError with the first divergent round otherwise.
    """
    arr = np.asarray(per_rank, np.float32)
    glob = np.asarray(per_round, np.float32)
    sums = arr.sum(axis=1, dtype=np.float32)
    rr = min(sums.shape[0], glob.shape[0])
    if not np.array_equal(sums[:rr], glob[:rr]):
        bad = int(np.argwhere(~(sums[:rr] == glob[:rr]).all(axis=1))[0][0])
        raise ValueError(
            f"per-rank rows diverge from global channels at round {bad}"
            f"{' (' + label + ')' if label else ''}: "
            f"rank-sum {sums[bad].tolist()} != global {glob[bad].tolist()}"
        )


def analyze(per_rank, *, label: str = "") -> FlightReport:
    """Digests a (rounds, n_ranks, 4) flight buffer into a report."""
    arr = _as_per_rank(per_rank)
    rounds, n_ranks = arr.shape[0], arr.shape[1]
    rank_totals = arr.sum(axis=0)
    global_totals = rank_totals.sum(axis=0)
    imb = load_imbalance(arr)
    active = arr.max(axis=1) > 0  # (R, 4) per-channel activity mask
    mean_imb = np.where(
        active.sum(axis=0) > 0,
        imb.sum(axis=0, where=active) / np.maximum(active.sum(axis=0), 1),
        1.0,
    )
    peak_imb = imb.max(axis=0) if rounds else np.ones(4)
    msg_tot = rank_totals[:, MSG]
    skew = (
        float(msg_tot.max() / msg_tot.mean()) if msg_tot.mean() > 0 else 1.0
    )
    return FlightReport(
        label=label,
        rounds=rounds,
        n_ranks=n_ranks,
        channels=ROUND_CHANNELS,
        rank_totals=rank_totals,
        global_totals=global_totals,
        imbalance=imb,
        mean_imbalance=mean_imb,
        peak_imbalance=peak_imb,
        message_skew=skew,
        stragglers=straggler_ranks(arr),
    )


# ----------------------------------------------------------------------------
# dump / load / render
# ----------------------------------------------------------------------------


def dump_flight(
    path: str,
    per_rank,
    *,
    label: str = "",
    per_round=None,
    extra: Optional[Dict[str, object]] = None,
) -> None:
    """Writes a flight recording as JSON for an offline report."""
    doc: Dict[str, object] = {
        "label": label,
        "channels": list(ROUND_CHANNELS),
        "per_rank": np.asarray(per_rank, np.float64).tolist(),
    }
    if per_round is not None:
        doc["per_round"] = np.asarray(per_round, np.float64).tolist()
    if extra:
        doc["extra"] = dict(extra)
    with open(path, "w") as f:
        json.dump(doc, f)


def load_flight(path: str) -> Dict[str, object]:
    """Loads a dumped flight file; per_rank/per_round become ndarrays."""
    with open(path) as f:
        doc = json.load(f)
    if "per_rank" not in doc:
        raise ValueError(f"{path}: not a flight file (no 'per_rank' key)")
    doc["per_rank"] = np.asarray(doc["per_rank"], np.float32)
    if doc.get("per_round") is not None:
        doc["per_round"] = np.asarray(doc["per_round"], np.float32)
    return doc


def render_report(
    report: FlightReport, fmt: str = "text", top: int = 5
) -> str:
    """Renders a :class:`FlightReport` as text or markdown."""
    if fmt not in ("text", "markdown"):
        raise ValueError(f"fmt must be 'text' or 'markdown', got {fmt!r}")
    md = fmt == "markdown"
    lines = []
    title = f"Flight report{': ' + report.label if report.label else ''}"
    lines.append(f"## {title}" if md else title)
    lines.append("" if md else "=" * len(title))
    lines.append(
        f"rounds={report.rounds}  ranks={report.n_ranks}  "
        f"message_skew={report.message_skew:.3f}"
    )
    lines.append("")
    head = ["channel", "total", "mean imbalance", "peak imbalance"]
    rows = [
        [
            c,
            f"{report.global_totals[i]:.0f}",
            f"{report.mean_imbalance[i]:.3f}",
            f"{report.peak_imbalance[i]:.3f}",
        ]
        for i, c in enumerate(report.channels)
    ]
    lines.extend(_table(head, rows, md))
    lines.append("")
    strag = report.stragglers[:top]
    if strag:
        lines.append(
            ("**Stragglers**" if md else "Stragglers")
            + " (rounds carrying the message max):"
        )
        head = ["rank", "rounds at max", "messages", "share"]
        tot = max(float(report.global_totals[MSG]), 1.0)
        rows = [
            [
                str(r),
                str(c),
                f"{report.rank_totals[r, MSG]:.0f}",
                f"{report.rank_totals[r, MSG] / tot:.1%}",
            ]
            for r, c in strag
        ]
        lines.extend(_table(head, rows, md))
    return "\n".join(lines) + "\n"


def _table(head: Sequence[str], rows, md: bool):
    if md:
        out = ["| " + " | ".join(head) + " |"]
        out.append("|" + "|".join("---" for _ in head) + "|")
        out.extend("| " + " | ".join(r) + " |" for r in rows)
        return out
    widths = [
        max(len(head[i]), *(len(r[i]) for r in rows)) if rows else len(head[i])
        for i in range(len(head))
    ]
    out = ["  ".join(h.ljust(widths[i]) for i, h in enumerate(head))]
    out.append("  ".join("-" * w for w in widths))
    out.extend(
        "  ".join(c.rjust(widths[i]) for i, c in enumerate(r)) for r in rows
    )
    return out
