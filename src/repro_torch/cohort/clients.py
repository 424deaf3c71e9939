"""A rank's share of the cohort engines' client axis, and the collectives
of a tick whose ``[C, ...]`` state is cut over a ``clients`` mesh.

The device engine works on each rank's local rows (shard_map style: no
DTensor dispatch inside a tick) and makes its collectives explicitly on
the mesh's process group:

* ``allsum`` — one ``int32`` all-reduce of the tick's cross-client
  counts, packed into one vector (the branch predicates, the far plan's
  group counts);
* ``partials`` — tick_scatter's rows pass over the rank's rows under the
  GLOBAL partition of the C rows (``scatter_partition(C)``), a block that
  straddles a rank boundary continued from its running sum passed from
  the rank before (``carry``), and one all-gather that brings every
  complete block's partial to every rank in block order, with the ring
  counts riding in the same buffer as ``int32`` words.  Every rank then
  runs the same finish, so the server's rows come out the same on every
  rank and bit for bit those of one rank holding all C rows.

Without a mesh, or where ``_fit`` replicates the axis (C not divisible
by the ranks), the axis is not cut: one rows pass over all C rows, no
collective, the same code path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels.tick_fused import scatter_partition, tick_scatter_rows
from repro_torch.sharding import client_range

I32 = torch.int32


def _all_gather(out: torch.Tensor, t: torch.Tensor, group) -> None:
    """``out`` (every rank's ``t``, concatenated along dim 0) by one
    all-gather: ``all_gather_single`` where this torch has it, else
    ``all_gather_into_tensor``, its older name."""
    gather = getattr(dist, "all_gather_single", None)
    if gather is None:
        gather = dist.all_gather_into_tensor
    gather(out, t, group=group)


class ClientAxis:
    """Rows ``[lo, hi)`` of ``C`` clients on this rank of ``mesh`` (None:
    all of them, no process group)."""

    def __init__(self, mesh, C: int):
        self.C = int(C)
        self.lo, self.hi = client_range(mesh, self.C)
        self.n = self.hi - self.lo
        self.sharded = self.n < self.C
        self.rb, self.nblk = scatter_partition(self.C)
        #: collectives made, by kind: ``allreduce`` (the tick's int32
        #: counts), ``allgather`` (partials and ring counts), ``carry``
        #: (a straddling block's running sum to the next rank), ``report``
        #: (per-client counters gathered for a report or a trace)
        self.collectives: Dict[str, int] = {"allreduce": 0, "allgather": 0,
                                            "carry": 0, "report": 0}
        self.rank, self.P, self.group = 0, 1, None
        #: the engine's span recorder: each rows pass is recorded in its
        #: ``launches`` (None: nothing is recorded)
        self.spans = None
        if mesh is not None:       # a replicated axis too: rank 0 traces
            self.rank = mesh.get_local_rank("clients")
            self.P = mesh.size()
        if not self.sharded:
            return
        self.group = mesh.get_group("clients")
        rb, n = self.rb, self.n
        # rows [0, head) continue a block begun on an earlier rank; the
        # last block begun here runs on past hi unless hi is a boundary
        self.head = (0 if self.lo % rb == 0
                     else min(self.hi, (self.lo // rb + 1) * rb) - self.lo)
        self.send_tail = self.hi < self.C and self.hi % rb != 0
        # blocks whose last row each rank holds: its share of the gather
        self.complete = [
            sum(1 for b in range(self.nblk)
                if r * n <= min((b + 1) * rb, self.C) - 1 < (r + 1) * n)
            for r in range(self.P)]
        self._prev = (dist.get_global_rank(self.group, self.rank - 1)
                      if self.head else None)
        self._next = (dist.get_global_rank(self.group, self.rank + 1)
                      if self.send_tail else None)

    # -- int32 counts ------------------------------------------------------
    def allsum(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each int32 tensor of ``parts`` summed over the ranks (one
        all-reduce of them packed); unchanged where the axis is not
        cut."""
        if not self.sharded:
            return list(parts)
        flat = torch.cat([p.reshape(-1).to(I32) for p in parts])
        dist.all_reduce(flat, group=self.group)
        self.collectives["allreduce"] += 1
        out, o = [], 0
        for p in parts:
            out.append(flat[o:o + p.numel()].reshape(p.shape))
            o += p.numel()
        return out

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The whole ``[C, ...]`` tensor from every rank's rows (a report's
        per-client counters); ``t`` itself where the axis is not cut."""
        if not self.sharded:
            return t
        out = t.new_empty((self.C,) + tuple(t.shape[1:]))
        _all_gather(out, t.contiguous(), self.group)
        self.collectives["report"] += 1
        return out

    # -- the ring and far sums ---------------------------------------------
    def partials(self, sent, w, U, wgt, done, eta, *, dp_on: bool,
                 ints: Optional[torch.Tensor] = None):
        """tick_scatter's rows pass over this rank's rows with every
        block's partial brought to every rank: sent, w, U [n, D]; wgt
        [G, n]; done [n]; eta [n] -> (w', U', partials [blocks, G, D] of
        the global partition in block order, ``ints`` [m] int32 summed
        over the ranks)."""
        rb = self.rb
        wgt = wgt.contiguous()      # its column slices keep unit stride
        if not self.sharded:
            w_out, u_out, part = self._rows(
                sent, w, U, wgt, done, eta, dp_on=dp_on, rows_per_block=rb)
            return w_out, u_out, part, ints
        G, D = wgt.shape[0], sent.shape[1]
        h, n = self.head, self.n
        w_out, u_out = torch.empty_like(w), torch.empty_like(U)
        mine, send = [], None
        if h < n:                        # blocks begun on this rank
            _, _, body = self._rows(
                sent[h:], w[h:], U[h:], wgt[:, h:], done[h:], eta[h:],
                dp_on=dp_on, rows_per_block=rb,
                out=(w_out[h:], u_out[h:]))
            if self.send_tail:
                send, body = body[-1].contiguous(), body[:-1]
            mine.append(body)
        if h:                            # the block begun before lo
            carry = sent.new_empty((G, D))
            ops = [dist.P2POp(dist.irecv, carry, self._prev, self.group)]
            if send is not None:
                ops.append(dist.P2POp(dist.isend, send, self._next,
                                      self.group))
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            self.collectives["carry"] += 1
            _, _, first = self._rows(
                sent[:h], w[:h], U[:h], wgt[:, :h], done[:h], eta[:h],
                dp_on=dp_on, rows_per_block=rb, row_offset=self.lo % rb,
                carry=carry, out=(w_out[:h], u_out[:h]))
            if h == n and self.send_tail:    # it runs on past hi too
                dist.send(first[0].contiguous(), self._next,
                          group=self.group)
                self.collectives["carry"] += 1
            else:
                mine.insert(0, first)
        elif send is not None:
            dist.send(send, self._next, group=self.group)
            self.collectives["carry"] += 1
        part = self._gather(mine, G, D, ints, sent)
        return (w_out, u_out) + part

    def _rows(self, sent, w, U, wgt, done, eta, **kw):
        """One ``tick_scatter_rows`` launch, recorded in the span
        recorder's ``launches`` when there is one."""
        out = tick_scatter_rows(sent, w, U, wgt, done, eta, **kw)
        if self.spans is not None:
            self.spans.launches.append(("tick_scatter_rows", dict(
                C=sent.shape[0], D=sent.shape[1], G=wgt.shape[0],
                nd=done.sum(), nblk=out[2].shape[0])))
        return out

    def _gather(self, mine, G: int, D: int, ints, like):
        """One all-gather of every rank's complete partials (padded to the
        most any rank has) and its ``ints`` words -> (partials in block
        order, ints summed)."""
        per = G * D
        most = max(self.complete)
        ni = 0 if ints is None else ints.numel()
        buf = like.new_zeros((most * per + ni,))
        k = self.complete[self.rank]
        if k:
            buf[:k * per] = torch.cat(mine).reshape(-1)
        if ni:
            buf[most * per:] = ints.to(I32).contiguous().view(torch.float32)
        out = like.new_empty((self.P * buf.numel(),))
        _all_gather(out, buf, self.group)
        self.collectives["allgather"] += 1
        out = out.view(self.P, buf.numel())
        part = torch.cat([out[r, :self.complete[r] * per]
                          for r in range(self.P)]).reshape(self.nblk, G, D)
        isum = (out[:, most * per:].contiguous().view(I32).sum(0, dtype=I32)
                if ni else None)
        return part, isum
