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
  ``fu_budgets`` [L, 7], ``mem_latency``/``ppb``/``max_cycles`` [L],
  the NTX leaf-path tables ``direct``/``offset`` [L, A, D] and
  ``parity`` [L, A, D, PP];
* shared by every lane (the trace's ``DeviceViews``): ``n_real``,
  ``preds_pad`` [NPAD, P], ``lat`` [NPAD], ``is_load`` [NPAD] bool,
  ``word_idx`` [NPAD], ``perm``/``gid_perm`` [NPAD], ``seg_start``
  [A + 8];
* static: ``scan_slots`` (S), ``key_space`` (U), ``bank_slots`` (NB)
  and ``record``.

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
                                          F_SLOTS, F_SUB, F_WR,
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
# error codes of a lane (the host raises the reference loops' exceptions)
ERR_NONE, ERR_MAX_CYCLES, ERR_DEADLOCK, ERR_UNCONFIGURED = 0, 1, 2, 3


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
 _C_MLAT) = range(16)


def cycle_lanes_plain(desc, fu_budgets, mem_latency, ppb, max_cycles,
                      direct, offset, parity, n_real, preds_pad, lat,
                      is_load, word_idx, perm, gid_perm, seg_start, *,
                      scan_slots: int, key_space: int, bank_slots: int,
                      record: bool = False) -> tuple:
    """Plain PyTorch version: the reference lane with the ``vmap`` axis
    written out as a leading lane axis on every piece of per-design
    state (trace tensors shared).

    The reference's batched ``while_loop`` keeps stepping while any lane
    runs and drops the update of lanes that have stopped; here a lane
    that has stopped keeps its ``cycle``/``err``/counters by masking,
    and its other state is inert (no node of it is ready any more).

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
    D, PP = direct.shape[2], parity.shape[3]
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
    direct, offset, parity = direct.to(I32), offset.to(I32), parity.to(I32)

    kind = desc[..., F_KIND]
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
        mem_latency.to(I32)[:, None].expand(L, A)], -1).to(I32)
    configured = const[..., _C_CONF] > 0
    const = const.reshape(L * A, -1)
    c_conf, c_banked, c_simple = (const[:, f] > 0 for f in (
        _C_CONF, _C_BANKED, _C_SIMPLE))
    c_nbanks, c_maxfail = const[:, _C_NBANKS], const[:, _C_MAXFAIL]
    direct_f, offset_f = direct.reshape(-1), offset.reshape(-1)
    parity_f = parity.reshape(-1)
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
        ready = (~iss_r) & (finish[:, preds] <= cyc[:, :, None]).all(-1)
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
            cc = const.index_select(0, pair).t()[..., None]  # [16, M, 1]
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
                ta = (a - tree * half).clamp(max=D - 1).long()
                b_d = pair[:, None] * D + ta
                leaf = direct_f.take(b_d)
                soff = torch.remainder(offset_f.take(b_d), sub)
                key1 = (tree * nl + leaf) * sub + soff
                key2 = (2 * nl + leaf) * sub + soff
                key_other = ((1 - tree) * nl + leaf) * sub + soff
                u2 = use.take(b_use + key2.clamp(max=U))
                direct_free = ~use.take(b_use + key1.clamp(max=U)) \
                    & (is_h | ~u2)
                pl = parity_f.take(b_d[..., None] * PP + ar_pp)  # [M,W,PP]
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
    fn.argtypes = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 11 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def cycle_lanes(desc, fu_budgets, mem_latency, ppb, max_cycles, direct,
                offset, parity, n_real: int, preds_pad, lat, is_load,
                word_idx, perm, gid_perm, seg_start, *, scan_slots: int,
                key_space: int, bank_slots: int, record: bool = False
                ) -> tuple:
    """Schedule every lane (see the module docstring for the layout).

    CUDA tensors launch ``csrc/cycle_lanes.cu`` once for all lanes (one
    CTA a lane; the lanes' node-sized workspace is allocated here with
    ``torch.empty`` and initialised by the kernel); CPU tensors run
    :func:`cycle_lanes_plain`."""
    ins = (desc, fu_budgets, mem_latency, ppb, max_cycles, direct, offset,
           parity, preds_pad, lat, is_load, word_idx, perm, gid_perm,
           seg_start)
    if _build.dispatch(*ins) == "cpu":
        return cycle_lanes_plain(
            desc, fu_budgets, mem_latency, ppb, max_cycles, direct, offset,
            parity, n_real, preds_pad, lat, is_load, word_idx, perm,
            gid_perm, seg_start, scan_slots=scan_slots, key_space=key_space,
            bank_slots=bank_slots, record=record)
    dev = desc.device
    L, A = desc.shape[0], desc.shape[1]
    NPAD, P = preds_pad.shape
    D, PP = direct.shape[2], parity.shape[3]
    i32 = (torch.int32,)
    for name, t, shape in (
            ("desc", desc, (L, A, N_FIELDS)), ("fu_budgets", fu_budgets,
                                               (L, N_FU)),
            ("mem_latency", mem_latency, (L,)), ("ppb", ppb, (L,)),
            ("max_cycles", max_cycles, (L,)), ("direct", direct, (L, A, D)),
            ("offset", offset, (L, A, D)), ("parity", parity,
                                            (L, A, D, PP)),
            ("preds_pad", preds_pad, (NPAD, P)), ("lat", lat, (NPAD,)),
            ("word_idx", word_idx, (NPAD,)), ("perm", perm, (NPAD,)),
            ("gid_perm", gid_perm, (NPAD,)),
            ("seg_start", seg_start, (A + N_FU + 1,))):
        _build.check_tensor(name, t, dev, i32, shape)
    _build.check_tensor("is_load", is_load, dev, (torch.bool,), (NPAD,))
    cycles = torch.empty(L, dtype=I32, device=dev)
    cnt = torch.empty((L, 8), dtype=I32, device=dev)
    per_array = torch.empty((L, A), dtype=I32, device=dev)
    err = torch.empty(L, dtype=I32, device=dev)
    maps = torch.empty((L, A, D), dtype=I32, device=dev)
    events = (torch.empty((L, 4, NPAD), dtype=I32, device=dev) if record
              else None)
    finish_ws = torch.empty((L, NPAD + 1), dtype=I32, device=dev)
    delayed_ws = torch.empty((L, NPAD), dtype=torch.uint8, device=dev)
    lib, fn = _launcher()
    with torch.cuda.device(dev):
        code = fn(desc.data_ptr(), fu_budgets.data_ptr(),
                  mem_latency.data_ptr(), ppb.data_ptr(),
                  max_cycles.data_ptr(), direct.data_ptr(),
                  offset.data_ptr(), parity.data_ptr(),
                  preds_pad.data_ptr(), lat.data_ptr(), is_load.data_ptr(),
                  word_idx.data_ptr(), perm.data_ptr(), gid_perm.data_ptr(),
                  seg_start.data_ptr(), cycles.data_ptr(), cnt.data_ptr(),
                  per_array.data_ptr(), err.data_ptr(), maps.data_ptr(),
                  events.data_ptr() if record else None,
                  finish_ws.data_ptr(), delayed_ws.data_ptr(),
                  L, A, NPAD, P, int(n_real), max(scan_slots, 1),
                  max(key_space, 1), max(bank_slots, 1), D, PP, int(record),
                  _build.stream_ptr(desc))
    _build.check_status(lib, code, "cycle_lanes")
    cycle_lanes.launches += 1
    out = (cycles, cnt, per_array, err, maps)
    return out + (events,) if record else out


cycle_lanes.launches = 0
