"""The batched timing backend's lane loop: every design lane of a DSE
grid scheduled over one trace to completion.

This is the port of the JAX package's ``core/sim/jax_cycle.py``
``_make_lane_fn`` (a ``lax.while_loop`` over simulated cycles holding a
second ``while_loop``, the per-array deferral scan, ``vmap``-ped over
the design lanes).  It is not a Pallas kernel; on the card it becomes
``csrc/cycle_lanes.cu``, one CTA per lane running the whole cycle loop
in one launch.

Inputs (the same as the reference's ``_compiled(...)`` call):

* per lane ``[L, ...]``: ``desc`` [L, A, N_FIELDS] descriptor rows,
  ``fu_budgets`` [L, 7], ``mem_latency``/``ppb``/``max_cycles`` [L];
* ``table_depth`` (D): the words of per-word state, the remap live map's
  and the clamp of an NTX in-tree address.  The NTX leaf paths of a
  word are computed from its array's descriptor row
  (``F_TREE_DEPTH``, ``F_LEVELS``; :func:`ntx_leaf_paths`), as rows
  ``[0, D)`` of ``arbiter.ntx_tables`` zero-padded past the tree;
* shared by every lane (the trace's ``DeviceViews``): ``n_real``,
  ``preds_pad`` [NPAD, P], ``lat`` [NPAD], ``is_load`` [NPAD] bool,
  ``word_idx`` [NPAD], ``perm``/``gid_perm`` [NPAD], ``seg_start``
  [A + 8];
* the kernel's view of the same trace by priority position (built by
  ``core/sim/batched_cycle.py::_kernel_layout``; the plain version does
  not read it): ``x_pos``/``word_pos`` [n_real], the successor CSR
  ``succ_ptr`` [n_real + 1]/``succ_pos`` [E] and the packed in-degree
  seeds ``pend0``;
* static: ``scan_slots`` (S), ``key_space`` (U), ``bank_slots`` (NB),
  ``pend_bits``, ``wheel_slots`` (W), ``wheel_depth`` and ``record``.

Outputs: ``cycles`` [L], ``cnt`` [L, 8] (issued, mem issued, the three
stall causes, parity-path reads, write-pair RMWs, cycles with a memory
issue), ``per_array`` [L, A], ``err`` [L] (``ERR_*``) and the final
remap maps [L, A, D]; with ``record`` also the event log [L, 4, NPAD]
(cycle, path, resource, slot per node).

``cycle_lanes`` dispatches on the device only: CUDA tensors launch the
kernel (``cycle_lanes.launches`` counts the launches), CPU tensors run
``cycle_lanes_plain``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.sim.arbiter import (F_CONFIGURED, F_DEPTH, F_HALF,
                                          F_KIND, F_LEVELS, F_MAXFAIL,
                                          F_NBANKS, F_NLEAVES, F_RD,
                                          F_SLOTS, F_SUB, F_TREE_DEPTH, F_WR,
                                          KIND_BANKED, KIND_H_NTX,
                                          KIND_LVT, KIND_REMAP, N_FIELDS,
                                          _NTX_KINDS)
from repro_torch.core.sim.events import (PATH_BROADCAST, PATH_COMPUTE,
                                         PATH_DIRECT, PATH_PAIR_RMW,
                                         PATH_PARITY, PATH_STEERED)
from repro_torch.kernels import _build

I32 = torch.int32
INT32_INF = 2**31 - 1
N_FU = 7
# error codes of a lane (the host raises the reference loops' exceptions;
# ERR_WHEEL, a finish-wheel overflow, is the kernel's own)
ERR_NONE, ERR_MAX_CYCLES, ERR_DEADLOCK, ERR_UNCONFIGURED, ERR_WHEEL = range(5)


def _steer(wuse_o, ruse_o, valid, ppb):
    """Remap write steering: the first free bank in live-map scan order
    (no write yet this cycle and a port left).  Returns ``(any_free,
    position)`` along the last axis; ``position`` is 0 when none is."""
    free = (wuse_o == 0) & (ruse_o < ppb) & valid
    return free.any(-1), torch.argmax(free.to(torch.uint8), -1).to(I32)


# how far one step of the plain deferral scan looks ahead (candidates)
_WINDOW = 64
# per (lane, array) scan state, one int32 column each
(_RD, _WR, _SLOTS, _FAILED, _SAT, _STOP, _PAIRU, _J, _MEMPA, _ST_BANK,
 _ST_PARITY, _ST_PAIR, _PR, _RMW) = range(14)
# per (lane, array) design constants
(_C_H, _C_NTX, _C_BANKED, _C_REMAP, _C_SIMPLE, _C_LVT, _C_CONF, _C_NBANKS,
 _C_DEPTH, _C_HALF, _C_SUB, _C_MAXFAIL, _C_NL, _C_NPATHS, _C_PPB,
 _C_MLAT, _C_TREE_DEPTH, _C_LEVELS) = range(18)


def ntx_leaf_paths(ta, tree_depth, levels, n_paths: int) -> tuple:
    """The NTX leaf paths of in-tree address ``ta``: ``(leaf, offset,
    parity)``, what rows ``ta`` of ``arbiter.ntx_tables(tree_depth,
    levels)`` hold, with ``parity`` along a trailing axis of ``n_paths``
    (a power of two, at least ``2**levels``).

    Each of the ``levels`` levels halves the range (``cur >> 1``) and
    gives one bit, whether the offset lies in the upper half; the direct
    leaf is the bits read in base 3, and parity leaf ``q`` takes the
    digit 2 where ``q``'s bit for the level is set, else the other
    child's.  Where ``ta >= tree_depth`` (rows the zero-padded tables
    held as zeros) every output is 0, as are the parity leaves past
    ``2**levels``.  Arguments broadcast; int32 tensors."""
    inside = ta < tree_depth
    off = torch.where(inside, ta, 0)
    leaf = torch.zeros_like(off)
    cur = tree_depth
    q = torch.arange(n_paths, dtype=I32, device=off.device)
    parity = torch.zeros(off.shape + (n_paths,), dtype=I32,
                         device=off.device)
    for lvl in range(n_paths.bit_length() - 1):
        walk = inside & (lvl < levels)
        h = cur >> 1
        hi = walk & (off >= h)
        off = off - torch.where(hi, h, 0)
        leaf = torch.where(walk, 3 * leaf + hi.to(I32), leaf)
        cur = h
        ref = (q >> (levels - 1 - lvl).clamp(min=0)[..., None]) & 1
        digit = torch.where(ref > 0, 2, 1 - hi.to(I32)[..., None])
        parity = torch.where(walk[..., None], 3 * parity + digit, parity)
    npaths = (torch.ones_like(levels) << levels)[..., None]
    return leaf, off, torch.where(q < npaths, parity, 0)


def cycle_lanes_plain(desc, fu_budgets, mem_latency, ppb, max_cycles,
                      table_depth: int, n_real, preds_pad, lat, is_load,
                      word_idx, perm, gid_perm, seg_start, *,
                      scan_slots: int, key_space: int, bank_slots: int,
                      record: bool = False) -> tuple:
    """Plain PyTorch version: the reference lane with the ``vmap`` axis
    written out as a leading lane axis on every piece of per-design
    state (trace tensors shared).

    The reference's batched ``while_loop`` keeps stepping while any lane
    runs and drops the update of lanes that have stopped; here a lane
    that has stopped keeps its ``cycle``/``err``/counters by masking,
    and its other state by having no node ready (a lane that stops in
    error may still hold ready nodes and nodes in flight).

    The deferral scan pops each array's candidates in order; a step
    works on the (lane, array) pairs still scanning.  Between two issues
    an array's port state does not change, so every pop up to the next
    issue is judged against the same state: one step looks up to
    ``_WINDOW`` candidates ahead, applies the deferrals before the first
    one that issues in bulk (their ``failed`` counts, first-deferral
    stalls and ``delayed`` marks, capped by ``max_failed`` as the one-pop
    loop caps them) and then issues that one exactly as the reference's
    pop does.
    The result is the one-pop loop's, pop for pop.  JAX clamps
    out-of-range gathers and drops out-of-range scatters: every scatter
    here goes through the reference's trash slots, and the gathers that
    can fall out of range (the NTX port keys of a non-NTX array when the
    batch's key space is one) are clamped as JAX clamps them."""
    dev = desc.device
    L, A = desc.shape[0], desc.shape[1]
    NPAD = perm.shape[0]
    S, U, NB = max(scan_slots, 1), max(key_space, 1), max(bank_slots, 1)
    D = max(int(table_depth), 1)
    W = max(1, min(_WINDOW, S))
    TRASH = NPAD + 1
    desc = desc.to(I32)
    max_cycles = max_cycles.to(I32)
    preds = preds_pad.long()
    perm_l = perm.long()
    gid = gid_perm.long()
    seg = seg_start.long()
    lat_i = lat.to(I32)
    lat_p = lat_i[perm_l]
    word_idx = word_idx.to(I32)
    is_load = is_load.to(torch.bool)

    kind = desc[..., F_KIND]
    # the widest NTX parity fan-out of the batch
    PP = 1 << int(desc[..., F_LEVELS].max()) if desc.numel() else 1
    is_ntx = ((kind == _NTX_KINDS[0]) | (kind == _NTX_KINDS[1])
              | (kind == _NTX_KINDS[2]))
    is_banked, is_remap = kind == KIND_BANKED, kind == KIND_REMAP
    const = torch.stack([
        kind == KIND_H_NTX, is_ntx, is_banked, is_remap,
        ~(is_ntx | is_banked | is_remap), kind == KIND_LVT,
        desc[..., F_CONFIGURED] > 0, desc[..., F_NBANKS].clamp(min=1),
        desc[..., F_DEPTH].clamp(min=1), desc[..., F_HALF].clamp(min=0),
        desc[..., F_SUB].clamp(min=1), desc[..., F_MAXFAIL],
        desc[..., F_NLEAVES].clamp(min=1),
        torch.ones_like(kind) << desc[..., F_LEVELS],
        ppb.to(I32)[:, None].expand(L, A),
        mem_latency.to(I32)[:, None].expand(L, A),
        desc[..., F_TREE_DEPTH], desc[..., F_LEVELS]], -1).to(I32)
    configured = const[..., _C_CONF] > 0
    const = const.reshape(L * A, -1)
    c_conf, c_banked, c_simple = (const[:, f] > 0 for f in (
        _C_CONF, _C_BANKED, _C_SIMPLE))
    c_nbanks, c_maxfail = const[:, _C_NBANKS], const[:, _C_MAXFAIL]
    ar_pp = torch.arange(PP, device=dev)
    ar_nb = torch.arange(NB, device=dev, dtype=I32)
    ar_win = torch.arange(W, device=dev)
    # mem / FU / pad segment budgets, by class id
    budget_of = torch.cat([torch.zeros((L, A), dtype=I32, device=dev),
                           fu_budgets.to(I32),
                           torch.zeros((L, 1), dtype=I32, device=dev)], 1)
    budget_p = budget_of[:, gid]                             # [L, NPAD]
    is_mem_p = gid < A
    slot_base = gid * (S + 1)
    st0 = torch.zeros((L * A, 14), dtype=I32, device=dev)
    st0[:, _RD] = desc[..., F_RD].reshape(-1)
    st0[:, _WR] = desc[..., F_WR].reshape(-1)
    st0[:, _SLOTS] = desc[..., F_SLOTS].reshape(-1)

    # lane state
    cycle = torch.zeros(L, dtype=I32, device=dev)
    remaining = torch.full((L,), int(n_real), dtype=I32, device=dev)
    finish = torch.full((L, NPAD + 2), INT32_INF, dtype=I32, device=dev)
    finish[:, NPAD] = -1                     # the always-retired pred
    issued = torch.zeros((L, NPAD + 2), dtype=torch.bool, device=dev)
    delayed = torch.zeros((L, NPAD + 2), dtype=torch.bool, device=dev)
    amap = torch.zeros(L * A * (D + 1), dtype=I32, device=dev)
    cnt = torch.zeros((L, 8), dtype=I32, device=dev)
    per_array = torch.zeros((L, A), dtype=I32, device=dev)
    err = torch.zeros(L, dtype=I32, device=dev)
    ev = (torch.full((L, 4, NPAD + 2), -1, dtype=I32, device=dev)
          if record else None)

    while True:
        live = (remaining > 0) & (err == ERR_NONE)
        if not bool(live.any()):
            break
        cyc = cycle[:, None]
        err_c = torch.where((err == ERR_NONE) & (cycle > max_cycles),
                            ERR_MAX_CYCLES, err)
        # ---- retire: a node is retired once issued & finish <= cycle
        fin_r = finish[:, :NPAD]
        iss_r = issued[:, :NPAD]
        remaining_c = int(n_real) - (iss_r & (fin_r <= cyc)).sum(
            1, dtype=I32)
        # a lane that has stopped has nothing ready: it issues nothing
        ready = (~iss_r) & (finish[:, preds] <= cyc[:, :, None]).all(-1) \
            & live[:, None]
        ready_p = ready[:, perm_l]

        # ---- one segmented rank pass over the whole priority perm
        cs0 = torch.zeros((L, NPAD + 1), dtype=I32, device=dev)
        torch.cumsum(ready_p.to(I32), 1, dtype=I32, out=cs0[:, 1:])
        rank = cs0[:, 1:] - cs0[:, seg[gid]]
        take = ready_p & (rank <= budget_p)
        tgt = torch.where(take, perm_l, TRASH)
        finish.scatter_(1, tgt, cyc + lat_p)
        issued.scatter_(1, tgt, True)
        if record:
            ev[:, 0].scatter_(1, tgt, cyc.expand(L, NPAD))
            ev[:, 1].scatter_(1, tgt, PATH_COMPUTE)
            ev[:, 3].scatter_(1, tgt, rank - 1)
        fu_issue_n = take.sum(1, dtype=I32)

        # ---- memory classes: segmented prefix -> per-array scan slots
        pos = rank - 1
        slot = torch.where(is_mem_p & ready_p & (pos < S), slot_base + pos,
                           A * (S + 1))
        cand = torch.zeros((L, A * (S + 1) + 1), dtype=torch.long,
                           device=dev)
        cand.scatter_(1, slot.long(), perm_l.expand(L, NPAD))
        cand = cand[:, :A * (S + 1)].reshape(L, A, S + 1)
        n_ready = cs0[:, seg[1:A + 1]] - cs0[:, seg[:A]]
        ncand = n_ready.clamp(max=S)
        err_c = torch.where(
            (err_c == ERR_NONE) & ((n_ready > 0) & ~configured).any(1),
            ERR_UNCONFIGURED, err_c)

        # ---- deferral scan: each array pops its candidates in order
        st = st0.clone()                                     # [L*A, 14]
        wr_half = torch.zeros(L * A * 3, dtype=I32, device=dev)
        ruse = torch.zeros(L * A * (NB + 1), dtype=I32, device=dev)
        wuse = torch.zeros_like(ruse)
        use = torch.zeros(L * A * (U + 1), dtype=torch.bool, device=dev)
        cand_f = cand.reshape(-1)
        ncand_f = ncand.reshape(-1)
        while True:
            rd_a, wr_a = st[:, _RD], st[:, _WR]
            have = (rd_a > 0) | (wr_a > 0)
            under_cap = st[:, _FAILED] < c_maxfail
            top = torch.where(
                c_banked, have & (st[:, _SAT] < c_nbanks) & under_cap,
                torch.where(c_simple, have & (st[:, _SLOTS] > 0),
                            have & under_cap))
            act = (st[:, _J] < ncand_f) & (st[:, _STOP] == 0) \
                & c_conf & top
            pair = act.nonzero()[:, 0]                       # [M]
            if pair.numel() == 0:
                break
            s = st.index_select(0, pair)                     # [M, 14]
            cc = const.index_select(0, pair).t()[..., None]  # [18, M, 1]
            lane = torch.div(pair, A, rounding_mode="floor")
            is_h, ntx, banked, remap, simple = (
                cc[f] > 0 for f in (_C_H, _C_NTX, _C_BANKED, _C_REMAP,
                                    _C_SIMPLE))
            any_ntx = bool(ntx.any())
            any_remap = bool(remap.any())
            n_banks, depth, half, sub, max_failed, nl, ppb_m = (
                cc[f] for f in (_C_NBANKS, _C_DEPTH, _C_HALF, _C_SUB,
                                _C_MAXFAIL, _C_NL, _C_PPB))
            rd, wr, failed, jj = (s[:, f:f + 1] for f in (_RD, _WR, _FAILED,
                                                          _J))
            b_use = pair[:, None] * (U + 1)
            b_nb = pair[:, None] * (NB + 1)
            # ---- look ahead: the pops up to the first issue, in one step
            # (no wider than the most pops a pair has left)
            left = torch.minimum(ncand_f.index_select(0, pair)[:, None] - jj,
                                 max_failed - failed)
            ar_w = ar_win[:max(1, min(W, int(left.max())))]
            k = jj.long() + ar_w                             # [M, W]
            valid = ar_w < left
            node_w = cand_f.take(pair[:, None] * (S + 1)
                                 + k.clamp(max=S - 1))
            ld = is_load.take(node_w)
            w = word_idx.take(node_w)
            dir_defer = torch.where(ld, rd <= 0, wr <= 0)
            a = torch.remainder(w, depth)
            ok = torch.ones_like(ld)
            if any_ntx:
                # NTX geometry: tree / in-tree address / leaf / sub-bank
                tree = torch.where(is_h, 0, (a >= half).to(I32))
                ta = (a - tree * half).clamp(max=D - 1)
                leaf, off, pl = ntx_leaf_paths(ta, cc[_C_TREE_DEPTH],
                                               cc[_C_LEVELS], PP)
                soff = torch.remainder(off, sub)
                key1 = (tree * nl + leaf) * sub + soff
                key2 = (2 * nl + leaf) * sub + soff
                key_other = ((1 - tree) * nl + leaf) * sub + soff
                u2 = use.take(b_use + key2.clamp(max=U))
                direct_free = ~use.take(b_use + key1.clamp(max=U)) \
                    & (is_h | ~u2)
                pk_t = (tree[..., None] * nl[..., None] + pl) \
                    * sub[..., None] + soff[..., None]
                pk_r = (2 * nl[..., None] + pl) * sub[..., None] \
                    + soff[..., None]
                pvalid = ar_pp < cc[_C_NPATHS][..., None]    # [M, 1, PP]
                b_use3 = b_use[..., None]
                p_busy = use.take(b_use3 + pk_t.clamp(max=U)) \
                    | (~is_h[..., None] & use.take(b_use3
                                                   + pk_r.clamp(max=U)))
                parity_free = ~(pvalid & p_busy).any(-1)
                tree01 = tree.clamp(max=1)
                first_w = wr_half.take(pair[:, None] * 3 + tree01) == 0
                pair_ok = (s[:, _PAIRU:_PAIRU + 1] == 0) \
                    & ~use.take(b_use + key_other.clamp(max=U)) & ~u2
                ok = torch.where(ntx, torch.where(
                    ld, direct_free | parity_free, is_h | first_w | pair_ok),
                    ok)
            bankb = torch.remainder(w, n_banks)
            used_b = ruse.take(b_nb + bankb)
            ok = torch.where(banked, used_b < ppb_m, ok)
            bank_valid = ar_nb < n_banks                     # [M, NB]
            if any_remap:
                # remap: live-bank read; a write needs a bank with no
                # write yet and a port left (which one is chosen on issue)
                mb = amap.take(pair[:, None] * (D + 1) + a.clamp(max=D - 1))
                b_banks = b_nb + ar_nb
                free_w = ((wuse.take(b_banks) == 0)
                          & (ruse.take(b_banks) < ppb_m)
                          & bank_valid).any(-1, keepdim=True)
                ok = torch.where(remap, torch.where(
                    ld, ruse.take(b_nb + mb) < ppb_m, free_w), ok)
            would = valid & ~dir_defer & ok
            has = would.any(-1, keepdim=True)                # [M, 1]
            p = torch.argmax(would.to(torch.uint8), -1, keepdim=True)
            n_def = torch.where(has, p, valid.sum(-1, keepdim=True))
            # the deferrals before the first issue
            defer = valid & (ar_w < n_def) & ~dir_defer
            n_idx = lane[:, None] * (NPAD + 2) + node_w
            first = defer & ~delayed.take(n_idx)
            delayed.view(-1).index_fill_(0, n_idx[first], True)
            # cause: bank (banked/remap), parity (NTX read), pair (NTX
            # write); ideal-like kinds never defer on ok
            s[:, _ST_BANK] += (first & ~ntx).sum(1)
            s[:, _ST_PARITY] += (first & ntx & ld).sum(1)
            s[:, _ST_PAIR] += (first & ntx & ~ld).sum(1)
            s[:, _FAILED] += n_def[:, 0].to(I32)
            s[:, _STOP] |= (simple[:, 0] & (s[:, _FAILED] >= max_failed[:, 0])
                            ).to(I32)
            s[:, _J] += n_def[:, 0].to(I32)

            # ---- the issuing pop, exactly the reference's
            def at(x):
                return x.gather(1, p) if x.dim() == 2 else \
                    x.gather(1, p[..., None].expand(-1, 1, PP))[:, 0]
            issue = has
            node, ld1 = at(node_w), at(ld)
            s[:, _RD] -= (issue & ld1)[:, 0].to(I32)
            s[:, _WR] -= (issue & ~ld1)[:, 0].to(I32)
            s[:, _SLOTS] -= (issue & simple)[:, 0].to(I32)
            bsel = issue & banked
            bank1 = at(bankb)
            s[:, _SAT] += (bsel & (at(used_b) + 1 == ppb_m))[:, 0].to(I32)
            ridx = torch.where(bsel, bank1, NB)
            rd_direct = rd_parity = w_pair = torch.zeros_like(issue)
            key1_1 = None
            if any_ntx:
                df1 = at(direct_free)
                rd_direct = issue & ntx & ld1 & df1
                rd_parity = issue & ntx & ld1 & ~df1
                ntx_w = issue & ntx & ~ld1 & ~is_h
                w_pair = ntx_w & ~at(first_w)
                pm = rd_parity & pvalid[:, 0]                # [M, PP]
                key1_1 = at(key1)
                kidx = torch.cat([key1_1, at(key2), at(key_other),
                                  at(pk_t), at(pk_r)], 1)
                kmsk = torch.cat([rd_direct, (rd_direct & ~is_h) | w_pair,
                                  w_pair, pm, pm & ~is_h], 1)
                use.index_fill_(0, (b_use + kidx)[kmsk], True)
                wr_half.index_add_(0, (pair[:, None] * 3 + at(tree01))[ntx_w],
                                   torch.ones_like(pair, dtype=I32)[
                                       ntx_w[:, 0]])
                s[:, _PAIRU] |= w_pair[:, 0].to(I32)
            rm_wr = torch.zeros_like(issue)
            if any_remap:
                rm_rd = issue & remap & ld1
                rm_wr = issue & remap & ~ld1
                mb1 = at(mb)
                worder = torch.remainder(mb1 + ar_nb, n_banks)   # [M, NB]
                _, wpos = _steer(wuse.take(b_nb + worder),
                                 ruse.take(b_nb + worder), bank_valid, ppb_m)
                wbank = worder.gather(1, wpos.long()[:, None])
                ridx = torch.where(rm_rd, mb1, torch.where(rm_wr, wbank,
                                                           ridx))
                wuse.index_fill_(0, (b_nb + wbank)[rm_wr], 1)
                amap.index_copy_(0, (pair[:, None] * (D + 1) + at(a))[rm_wr],
                                 wbank[rm_wr])
            ruse.index_add_(0, (b_nb + ridx)[ridx < NB],
                            torch.ones_like(pair, dtype=I32)[ridx[:, 0] < NB])
            # apply the issue to the lane's schedule state
            iss = issue[:, 0]
            t_idx = (lane[:, None] * (NPAD + 2) + node)[issue]
            latv = torch.where(ld1, cc[_C_MLAT], lat_i.take(node))
            finish.view(-1).index_copy_(0, t_idx,
                                        (cycle[lane][:, None] + latv)[issue])
            issued.view(-1).index_fill_(0, t_idx, True)
            if record:
                pathv = torch.where(
                    rd_parity, PATH_PARITY,
                    torch.where(w_pair, PATH_PAIR_RMW,
                                torch.where(rm_wr, PATH_STEERED,
                                            torch.where(~ld1 & (cc[_C_LVT]
                                                                > 0),
                                                        PATH_BROADCAST,
                                                        PATH_DIRECT))))
                resv = torch.where(bsel, bank1, -1)
                if any_remap:
                    resv = torch.where(rm_rd, mb1,
                                       torch.where(rm_wr, wbank, resv))
                if any_ntx:
                    resv = torch.where(rd_direct, key1_1, resv)
                e_idx = lane[iss] * (4 * (NPAD + 2)) + node[issue]
                ev_f = ev.view(-1)
                ev_f.index_copy_(0, e_idx, cycle[lane][iss])
                ev_f.index_copy_(0, e_idx + (NPAD + 2),
                                 pathv[issue].to(I32))
                ev_f.index_copy_(0, e_idx + 2 * (NPAD + 2),
                                 resv[issue].to(I32))
                ev_f.index_copy_(0, e_idx + 3 * (NPAD + 2),
                                 s[iss, _MEMPA])
            s[:, _MEMPA] += iss.to(I32)
            s[:, _PR] += rd_parity[:, 0].to(I32)
            s[:, _RMW] += w_pair[:, 0].to(I32)
            s[:, _J] += iss.to(I32)
            st.index_copy_(0, pair, s)

        st3 = st.view(L, A, 14)
        mem_pa = st3[..., _MEMPA]
        mem_add = mem_pa.sum(1, dtype=I32)
        any_mem = (mem_add > 0).to(I32)
        stall = st3[..., _ST_BANK:_RMW + 1].sum(1, dtype=I32)   # [L, 5]

        # ---- advance the clock (idle-cycle jump is cycle-exact)
        iss_r = issued[:, :NPAD]
        fin_r = finish[:, :NPAD]
        still_ready = (ready & ~iss_r).any(1)
        inflight = iss_r & (fin_r > cyc)
        any_inflight = inflight.any(1)
        next_finish = torch.where(inflight, fin_r, INT32_INF).amin(1)
        ncycle = cycle + 1
        ncycle = torch.where(~still_ready & any_inflight
                             & (next_finish > ncycle), next_finish, ncycle)
        err_c = torch.where((err_c == ERR_NONE) & ~still_ready
                            & ~any_inflight & (remaining_c > 0),
                            ERR_DEADLOCK, err_c)
        add = torch.cat([(fu_issue_n + mem_add)[:, None], mem_add[:, None],
                         stall, any_mem[:, None]], 1)
        # a lane that had stopped before this step keeps its state
        cycle = torch.where(live, ncycle, cycle)
        remaining = torch.where(live, remaining_c, remaining)
        err = torch.where(live, err_c, err)
        cnt += torch.where(live[:, None], add, 0)
        per_array += torch.where(live[:, None], mem_pa, 0)

    out = (cycle, cnt, per_array, err,
           amap.view(L, A, D + 1)[:, :, :D].contiguous())
    if record:
        return out + (ev[:, :, :NPAD].contiguous(),)
    return out


@functools.cache
def _launcher() -> tuple:
    lib = _build.load("cycle_lanes")
    fn = lib.cycle_lanes_launch
    fn.argtypes = [ctypes.c_void_p] * 24 + [ctypes.c_int] * 13 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    probe = lib.cycle_lanes_barrier_probe
    probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    probe.restype = ctypes.c_int
    return lib, fn


def cycle_lanes(desc, fu_budgets, mem_latency, ppb, max_cycles,
                table_depth: int, n_real: int, preds_pad, lat, is_load,
                word_idx, perm, gid_perm, seg_start, x_pos, word_pos,
                succ_ptr, succ_pos, pend0, *, scan_slots: int,
                key_space: int, bank_slots: int, pend_bits: int,
                wheel_slots: int, wheel_depth: int, record: bool = False,
                profile: bool = False) -> tuple:
    """Schedule every lane (see the module docstring for the layout).

    ``x_pos``, ``word_pos``, ``succ_ptr``, ``succ_pos`` and ``pend0``
    are the kernel's view of the same trace by priority position, with
    ``pend_bits``, ``wheel_slots`` and ``wheel_depth`` its sizes
    (``core/sim/batched_cycle.py::_kernel_layout``); the plain version
    reads the node-indexed inputs.  Both read ``seg_start`` [A + 8], the
    first position of each class's segment of ``perm`` (arrays, the 7
    FU classes, the trace's pads), the last entry the end of the FU
    classes: the kernel selects each class's first ready positions from
    its own segment.

    CUDA tensors launch ``csrc/cycle_lanes.cu`` once for all lanes (one
    CTA a lane; the lanes' pending counts, first-deferral flags and
    finish wheels are allocated here with ``torch.empty`` and
    initialised by the kernel); CPU tensors run
    :func:`cycle_lanes_plain`.  ``profile=True`` (the card only, not
    with ``record``) launches the profiling instantiation and appends a
    [L, 8] int64 tensor: the SM clocks each lane spent in its retire,
    ready counts, candidates (the arrays' selects), deferral scan and FU
    issue, and clock phases, the simulated cycles it visited, and the
    candidates its deferral scan popped and the rounds it took to pop
    them (a round judges up to 32 pops at once, one a thread of the
    array's warp); then a [L, 2] int64 tensor summed over the visited
    cycles: the ready-bitmap words the selects read and the bitmap's
    non-empty words (what a walk of the whole bitmap would read)."""
    ins = (desc, fu_budgets, mem_latency, ppb, max_cycles, preds_pad, lat,
           is_load, word_idx, perm, gid_perm, seg_start, x_pos, word_pos,
           succ_ptr, succ_pos, pend0)
    if _build.dispatch(*ins) == "cpu":
        if profile:
            raise ValueError("cycle_lanes: profile needs CUDA tensors")
        return cycle_lanes_plain(
            desc, fu_budgets, mem_latency, ppb, max_cycles, table_depth,
            n_real, preds_pad, lat, is_load, word_idx, perm, gid_perm,
            seg_start, scan_slots=scan_slots, key_space=key_space,
            bank_slots=bank_slots, record=record)
    if record and profile:
        raise ValueError("cycle_lanes: record and profile are exclusive")
    dev = desc.device
    L, A = desc.shape[0], desc.shape[1]
    NPAD, P = preds_pad.shape
    D = int(table_depth)
    n = int(n_real)
    per_word = 32 // pend_bits
    pend_words = max(1, -(-n // per_word))
    i32 = (torch.int32,)
    for name, t, shape in (
            ("desc", desc, (L, A, N_FIELDS)), ("fu_budgets", fu_budgets,
                                               (L, N_FU)),
            ("mem_latency", mem_latency, (L,)), ("ppb", ppb, (L,)),
            ("max_cycles", max_cycles, (L,)),
            ("preds_pad", preds_pad, (NPAD, P)), ("lat", lat, (NPAD,)),
            ("word_idx", word_idx, (NPAD,)), ("perm", perm, (NPAD,)),
            ("gid_perm", gid_perm, (NPAD,)),
            ("seg_start", seg_start, (A + N_FU + 1,)),
            ("x_pos", x_pos, (n,)), ("word_pos", word_pos, (n,)),
            ("succ_ptr", succ_ptr, (n + 1,)),
            ("succ_pos", succ_pos, (succ_pos.shape[0],)),
            ("pend0", pend0, (pend_words,))):
        _build.check_tensor(name, t, dev, i32, shape)
    _build.check_tensor("is_load", is_load, dev, (torch.bool,), (NPAD,))
    if pend_bits not in (8, 16, 32):
        raise ValueError(f"cycle_lanes: pend_bits {pend_bits} is not 8, "
                         "16 or 32")
    cycles = torch.empty(L, dtype=I32, device=dev)
    cnt = torch.empty((L, 8), dtype=I32, device=dev)
    per_array = torch.empty((L, A), dtype=I32, device=dev)
    err = torch.empty(L, dtype=I32, device=dev)
    maps = torch.empty((L, A, D), dtype=I32, device=dev)
    events = (torch.empty((L, 4, NPAD), dtype=I32, device=dev) if record
              else None)
    prof = (torch.empty((L, 8), dtype=torch.int64, device=dev) if profile
            else None)
    reads = (torch.empty((L, 2), dtype=torch.int64, device=dev) if profile
             else None)
    pend_ws = torch.empty((L, pend_words), dtype=I32, device=dev)
    delayed_ws = torch.empty((L, max(n, 1)), dtype=torch.uint8, device=dev)
    wheel_ws = torch.empty((L, wheel_slots, wheel_depth), dtype=I32,
                           device=dev)
    lib, fn = _launcher()
    with torch.cuda.device(dev):
        code = fn(desc.data_ptr(), fu_budgets.data_ptr(),
                  mem_latency.data_ptr(), ppb.data_ptr(),
                  max_cycles.data_ptr(), perm.data_ptr(),
                  gid_perm.data_ptr(), seg_start.data_ptr(),
                  x_pos.data_ptr(),
                  word_pos.data_ptr(), succ_ptr.data_ptr(),
                  succ_pos.data_ptr(), pend0.data_ptr(), cycles.data_ptr(),
                  cnt.data_ptr(), per_array.data_ptr(), err.data_ptr(),
                  maps.data_ptr(), events.data_ptr() if record else None,
                  prof.data_ptr() if profile else None,
                  reads.data_ptr() if profile else None, pend_ws.data_ptr(),
                  delayed_ws.data_ptr(), wheel_ws.data_ptr(), L, A, NPAD, n,
                  max(scan_slots, 1), max(key_space, 1), max(bank_slots, 1),
                  D, {8: 0, 16: 1, 32: 2}[pend_bits], pend_words,
                  wheel_slots, wheel_depth, int(record),
                  _build.stream_ptr(desc))
    _build.check_status(lib, code, "cycle_lanes")
    cycle_lanes.launches += 1
    out = (cycles, cnt, per_array, err, maps)
    if record:
        out = out + (events,)
    return out + (prof, reads) if profile else out


cycle_lanes.launches = 0


def barrier_ms(device, iters: int = 200_000) -> "tuple[float, float]":
    """The card's time for one block-wide barrier of a 512-thread CTA
    (the kernel's block size): one CTA crossing ``iters`` barriers,
    timed by CUDA events.  Returns ``(ms a barrier, SM clocks a
    barrier)``.  A measurement helper: it is no launch of the lane
    kernel and is not counted."""
    lib, _ = _launcher()
    clocks = torch.zeros(1, dtype=torch.int64, device=device)
    stream = _build.stream_ptr(clocks)
    with torch.cuda.device(clocks.device):
        _build.check_status(lib, lib.cycle_lanes_barrier_probe(
            iters, clocks.data_ptr(), stream), "barrier probe")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _build.check_status(lib, lib.cycle_lanes_barrier_probe(
            iters, clocks.data_ptr(), stream), "barrier probe")
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, int(clocks.item()) / iters
