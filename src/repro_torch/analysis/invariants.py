"""Trace invariant checker (rule family INV-*): model-check protocol
invariants over the JSONL telemetry traces the engines export
(``trace=`` kwarg, see ``repro_torch.telemetry.trace``).

The traces are the protocol's observable behavior; the invariants below
are the properties Theorem 1 / the wait gate / the census contract
guarantee, so a violating trace is a protocol bug regardless of which
engine produced it — the checker is the FAVAS-style posture of reasoning
about staleness and conservation on the trace, not in the engine.

Event-simulator traces (one record per send/apply/broadcast):

  INV-TAU     staleness-at-apply τ = server_k − k_send satisfies
              0 ≤ τ ≤ d − 1 at EVERY apply (the wait gate, Supp. B.2)
  INV-ROUND   round conservation: every completed server round r
              consumed exactly C applied updates with round == r
              (Algorithm 3's H set fills at C, never past it)
  INV-TIME    event times nondecreasing; server_k nondecreasing

Cohort-engine traces (one ``segment`` summary per eval boundary):

  INV-MONO    all cumulative segment counters (round, tick, messages,
              broadcasts, bytes_up_total) nondecreasing, and the
              staleness histogram entrywise nondecreasing
  INV-LATCH   overflow high-water mark is a latch: it never regresses
              across segments, and never exceeds the report's
              ``overflow_slots`` capacity

Profiling layer:

  INV-SPAN    op-census discipline: per-segment ``ops`` cost counters
              entrywise nondecreasing (they are cumulative), the final
              report's op census satisfies the ``costs.check_ops``
              relations against the message counts (complete_ticks ≤
              messages, far_ticks ≤ far_groups ≤ far_messages, ...),
              and — via ``check_perfetto`` — exported trace-event
              documents are well-formed with wall-clock slices
              non-overlapping per track

Final ``report`` record (all engines):

  INV-CENSUS  bytes-on-wire census consistent with message counts:
              Σ participation == messages, bytes_up[c] ==
              participation[c] · update_msg_bytes, bytes_down[c] ==
              broadcasts · broadcast_msg_bytes, Σ staleness_hist ≤
              messages, and (given d) all histogram mass sits in bins
              τ ≤ d − 1

``d`` (the paper's broadcast-lag gate) is a run parameter the trace
does not carry; pass it to enable the τ-bound checks.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

from repro_torch.analysis.base import Violation

Record = Dict[str, Any]


def read_trace(source: Union[str, Iterable[str]]) -> List[Record]:
    """JSONL path (or iterable of lines) -> list of records."""
    if isinstance(source, str):
        with open(source) as fh:
            lines = fh.readlines()
    else:
        lines = list(source)
    out: List[Record] = []
    for i, ln in enumerate(lines, 1):
        ln = ln.strip()
        if not ln:
            continue
        try:
            rec = json.loads(ln)
        except json.JSONDecodeError as e:
            raise ValueError(f"trace line {i} is not valid JSON: {e}")
        if not isinstance(rec, dict) or "kind" not in rec:
            raise ValueError(f"trace line {i} has no 'kind' field")
        out.append(rec)
    return out


def _v(rule: str, where: str, line: int, msg: str) -> Violation:
    return Violation(rule, where, line, msg)


def check_trace(trace: Union[str, Sequence[Record], Iterable[str]], *,
                d: Optional[int] = None,
                where: str = "<trace>") -> List[Violation]:
    """Model-check one engine trace; returns all violations found."""
    if isinstance(trace, str):
        where = trace
        records = read_trace(trace)
    else:
        records = list(trace)
        if records and isinstance(records[0], str):
            records = read_trace(records)

    out: List[Violation] = []
    report: Optional[Record] = None
    applied_by_round: Dict[int, int] = {}
    n_sent = n_fired = 0
    sent_bytes_total = 0
    last_time: Optional[float] = None
    last_server_k: Optional[int] = None
    prev_seg: Optional[Record] = None

    for i, rec in enumerate(records, 1):
        kind = rec.get("kind")
        # -- event-record family -------------------------------------------
        if kind in ("update_sent", "update_applied", "broadcast_fired",
                    "broadcast_applied"):
            t = rec.get("time")
            if t is not None:
                if last_time is not None and t < last_time:
                    out.append(_v("INV-TIME", where, i,
                                  f"event time regressed: {t} after "
                                  f"{last_time}"))
                last_time = t
        if kind == "update_sent":
            n_sent += 1
            sent_bytes_total += int(rec.get("bytes", 0))
        elif kind == "update_applied":
            tau = rec.get("staleness")
            sk = rec.get("server_k")
            if tau is None or sk is None:
                out.append(_v("INV-TAU", where, i,
                              "update_applied record lacks "
                              "staleness/server_k"))
                continue
            if tau < 0:
                out.append(_v("INV-TAU", where, i,
                              f"negative staleness {tau} (apply from the "
                              f"future: k_send > server_k)"))
            if d is not None and tau > d - 1:
                out.append(_v(
                    "INV-TAU", where, i,
                    f"staleness {tau} exceeds the wait-gate bound "
                    f"d-1={d - 1} at apply (client {rec.get('client')}, "
                    f"round {rec.get('round')})"))
            if last_server_k is not None and sk < last_server_k:
                out.append(_v("INV-TIME", where, i,
                              f"server_k regressed: {sk} after "
                              f"{last_server_k}"))
            last_server_k = sk
            r = rec.get("round")
            if r is not None:
                applied_by_round[int(r)] = \
                    applied_by_round.get(int(r), 0) + 1
        elif kind == "broadcast_fired":
            n_fired += 1
        # -- cohort segment family ------------------------------------------
        elif kind == "segment":
            if prev_seg is not None:
                for fld in ("round", "tick", "time", "messages",
                            "broadcasts", "bytes_up_total"):
                    a, b = prev_seg.get(fld), rec.get(fld)
                    if a is not None and b is not None and b < a:
                        out.append(_v(
                            "INV-MONO", where, i,
                            f"segment counter {fld} regressed: "
                            f"{b} after {a}"))
                ha = prev_seg.get("staleness_hist")
                hb = rec.get("staleness_hist")
                if ha is not None and hb is not None:
                    if len(ha) != len(hb):
                        out.append(_v("INV-MONO", where, i,
                                      "staleness_hist length changed "
                                      "between segments"))
                    elif any(y < x for x, y in zip(ha, hb)):
                        out.append(_v(
                            "INV-MONO", where, i,
                            f"staleness_hist regressed entrywise: "
                            f"{hb} after {ha}"))
                pa = prev_seg.get("ops")
                pb = rec.get("ops")
                if pa is not None and pb is not None:
                    if len(pa) != len(pb):
                        out.append(_v("INV-SPAN", where, i,
                                      "op-census length changed between "
                                      "segments"))
                    elif any(y < x for x, y in zip(pa, pb)):
                        out.append(_v(
                            "INV-SPAN", where, i,
                            f"op-census cost counters regressed "
                            f"entrywise: {pb} after {pa} — they are "
                            f"cumulative by construction"))
                oa = prev_seg.get("overflow_hwm")
                ob = rec.get("overflow_hwm")
                if oa is not None and ob is not None and ob < oa:
                    out.append(_v(
                        "INV-LATCH", where, i,
                        f"overflow_hwm latch regressed: {ob} after {oa} "
                        f"— the high-water mark is monotone by "
                        f"construction"))
            prev_seg = rec
        elif kind == "report":
            report = rec
            out.extend(check_report(rec, d=d, where=where, line=i))

    # -- cross-record checks needing the report -----------------------------
    if report is not None:
        C = report.get("clients")
        rounds = report.get("rounds")
        if applied_by_round and C and rounds is not None:
            for r in range(int(rounds)):
                got = applied_by_round.get(r, 0)
                if got != C:
                    out.append(_v(
                        "INV-ROUND", where, 0,
                        f"round {r} completed with {got} applied "
                        f"updates, want exactly C={C} (Algorithm 3's H "
                        f"fills at C) — an update was double-applied or "
                        f"lost"))
            for r, got in sorted(applied_by_round.items()):
                if r >= int(rounds) and got > C:
                    out.append(_v(
                        "INV-ROUND", where, 0,
                        f"in-flight round {r} already has {got} > C="
                        f"{C} applied updates"))
        if n_sent and report.get("messages") is not None \
                and n_sent != report["messages"]:
            out.append(_v(
                "INV-CENSUS", where, 0,
                f"{n_sent} update_sent records but report.messages="
                f"{report['messages']}"))
        if n_sent and report.get("bytes_up") is not None:
            census = sum(report["bytes_up"])
            if sent_bytes_total != census:
                out.append(_v(
                    "INV-CENSUS", where, 0,
                    f"sum of update_sent bytes {sent_bytes_total} != "
                    f"Σ report.bytes_up {census}"))
        if n_fired and report.get("broadcasts") is not None \
                and n_fired != report["broadcasts"]:
            out.append(_v(
                "INV-CENSUS", where, 0,
                f"{n_fired} broadcast_fired records but "
                f"report.broadcasts={report['broadcasts']}"))
        if prev_seg is not None:
            for fld, rfld in (("messages", "messages"),
                              ("broadcasts", "broadcasts"),
                              ("overflow_hwm", "overflow_hwm")):
                a, b = prev_seg.get(fld), report.get(rfld)
                if a is not None and b is not None and a > b:
                    out.append(_v(
                        "INV-MONO", where, 0,
                        f"final segment {fld}={a} exceeds report "
                        f"{rfld}={b}"))
    return out


def check_report(report: Record, *, d: Optional[int] = None,
                 where: str = "<report>", line: int = 0
                 ) -> List[Violation]:
    """Internal consistency of one MetricsReport record/dict."""
    out: List[Violation] = []
    part = report.get("participation")
    bytes_up = report.get("bytes_up")
    bytes_down = report.get("bytes_down")
    messages = report.get("messages")
    broadcasts = report.get("broadcasts")
    ub = report.get("update_msg_bytes")
    bb = report.get("broadcast_msg_bytes")
    hist = report.get("staleness_hist")
    if part is not None and messages is not None \
            and sum(part) != messages:
        out.append(_v("INV-CENSUS", where, line,
                      f"Σ participation {sum(part)} != messages "
                      f"{messages}"))
    if part is not None and bytes_up is not None and ub is not None:
        for c, (p, b) in enumerate(zip(part, bytes_up)):
            if b != p * ub:
                out.append(_v(
                    "INV-CENSUS", where, line,
                    f"client {c}: bytes_up {b} != participation {p} × "
                    f"update_msg_bytes {ub}"))
    if bytes_down is not None and broadcasts is not None \
            and bb is not None:
        for c, b in enumerate(bytes_down):
            if b != broadcasts * bb:
                out.append(_v(
                    "INV-CENSUS", where, line,
                    f"client {c}: bytes_down {b} != broadcasts "
                    f"{broadcasts} × broadcast_msg_bytes {bb}"))
    if hist is not None:
        if any(x < 0 for x in hist):
            out.append(_v("INV-CENSUS", where, line,
                          f"negative staleness_hist bin: {hist}"))
        if messages is not None and sum(hist) > messages:
            out.append(_v(
                "INV-CENSUS", where, line,
                f"Σ staleness_hist {sum(hist)} > messages {messages} "
                f"(an update was census-applied more than once)"))
        if d is not None and d - 1 < len(hist) - 1:
            extra = sum(hist[d:])
            if extra:
                out.append(_v(
                    "INV-TAU", where, line,
                    f"{extra} applies with staleness >= d={d} in the "
                    f"histogram {hist} — the wait gate bounds τ ≤ "
                    f"d-1={d - 1}"))
    hwm = report.get("overflow_hwm")
    slots = report.get("overflow_slots")
    if hwm is not None and slots:
        if hwm > slots:
            out.append(_v(
                "INV-LATCH", where, line,
                f"overflow_hwm {hwm} exceeds capacity overflow_slots "
                f"{slots} — the err latch should have stopped the run"))
    ops = report.get("ops")
    if ops:
        from repro_torch.telemetry.costs import check_ops
        for problem in check_ops(
                ops, messages=messages, broadcasts=broadcasts,
                far_messages=report.get("far_messages"),
                clients=report.get("clients"),
                ticks=report.get("ticks")):
            out.append(_v("INV-SPAN", where, line, problem))
    return out


def check_perfetto(doc: Union[str, Record], *,
                   where: str = "<perfetto>") -> List[Violation]:
    """INV-SPAN over an exported Chrome/Perfetto trace-event document
    (path or already-parsed dict): well-formed events, and "X" slices
    non-overlapping per (process, track)."""
    if isinstance(doc, str):
        where = doc
        with open(doc) as fh:
            doc = json.load(fh)
    from repro_torch.telemetry.spans import validate_trace_events
    return [_v("INV-SPAN", where, 0, problem)
            for problem in validate_trace_events(doc)]
