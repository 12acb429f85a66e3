"""VITERBI (MachSuite viterbi/viterbi): HMM decoding, min-sum over
-log-probabilities.

The transition matrix is walked down columns (stride = 8*n_states
bytes), the emission matrix is gathered through the observation tokens,
and the final traceback chases backpointers state-by-state — a
low-spatial-locality mix of strided and data-dependent accesses.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sim import trace as T


@dataclasses.dataclass(frozen=True)
class Params:
    n_states: int = 16       # MachSuite: N_STATES=64
    n_steps: int = 24        # MachSuite: N_OBS=140
    n_tokens: int = 32       # MachSuite: N_TOKENS=64
    seed: int = 31


TINY = Params(n_states=5, n_steps=8, n_tokens=8)


def make_inputs(p: Params) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(p.seed)
    return {
        "obs": rng.integers(0, p.n_tokens, size=p.n_steps).astype(np.uint8),
        "init": rng.uniform(0.1, 5.0, size=p.n_states),
        "transition": rng.uniform(0.1, 5.0, size=(p.n_states, p.n_states)),
        "emission": rng.uniform(0.1, 5.0, size=(p.n_states, p.n_tokens)),
    }


def run_np(obs: np.ndarray, init: np.ndarray, transition: np.ndarray,
           emission: np.ndarray) -> np.ndarray:
    """Most-likely state path (min-sum Viterbi with backtrack)."""
    t_n, s_n = obs.shape[0], init.shape[0]
    llike = np.zeros((t_n, s_n))
    bptr = np.zeros((t_n, s_n), np.int64)
    llike[0] = init + emission[:, obs[0]]
    for t in range(1, t_n):
        for curr in range(s_n):
            trans = llike[t - 1] + transition[:, curr]
            best = int(np.argmin(trans))
            bptr[t, curr] = best
            llike[t, curr] = trans[best] + emission[curr, obs[t]]
    path = np.zeros(t_n, np.int64)
    path[-1] = int(np.argmin(llike[-1]))
    for t in range(t_n - 2, -1, -1):
        path[t] = bptr[t + 1, path[t + 1]]
    return path


def run_torch(obs: torch.Tensor, init: torch.Tensor,
              transition: torch.Tensor, emission: torch.Tensor
              ) -> torch.Tensor:
    """Forward pass, one step at a time, and the backpointer chase on the
    device of ``init``; exact against :func:`run_np` (``torch.argmin``
    takes the first minimum, as ``np.argmin`` does)."""
    obs = obs.long()
    t_n = obs.shape[0]
    ll = init + emission[:, obs[0]]
    bptrs = []
    for t in range(1, t_n):
        trans = ll[:, None] + transition            # [prev, curr]
        bptrs.append(torch.argmin(trans, dim=0))    # per curr
        ll = trans.amin(dim=0) + emission[:, obs[t]]
    path = torch.empty(t_n, dtype=torch.int64, device=init.device)
    state = torch.argmin(ll)
    path[-1] = state
    for t in range(t_n - 2, -1, -1):
        state = bptrs[t][state]
        path[t] = state
    return path


def gen_trace(p: Params = Params()) -> T.Trace:
    inp = make_inputs(p)
    obs = inp["obs"]
    s_n, t_n = p.n_states, p.n_steps
    # mirror the DP to know the traceback addresses
    llike = np.zeros((t_n, s_n))
    bptr_np = np.zeros((t_n, s_n), np.int64)
    llike[0] = inp["init"] + inp["emission"][:, obs[0]]
    tb = T.TraceBuilder("viterbi")
    OBS = tb.declare_array("obs", 1)
    INIT = tb.declare_array("init", 8)
    TRANS = tb.declare_array("transition", 8)
    EMIS = tb.declare_array("emission", 8)
    LL = tb.declare_array("llike", 8)
    BP = tb.declare_array("bptr", 1)
    PATH = tb.declare_array("path", 1)
    last_ll: dict[int, int] = {}
    last_bp: dict[int, int] = {}
    lobs = tb.load(OBS, 0)
    for s in range(s_n):
        li = tb.load(INIT, s)
        le = tb.load(EMIS, s * p.n_tokens + int(obs[0]), (lobs,))
        add = tb.op(T.FADD, li, le)
        last_ll[s] = tb.store(LL, s, (add,))
    for t in range(1, t_n):
        lobs = tb.load(OBS, t)
        for curr in range(s_n):
            trans = llike[t - 1] + inp["transition"][:, curr]
            best = int(np.argmin(trans))
            bptr_np[t, curr] = best
            llike[t, curr] = trans[best] + inp["emission"][curr, int(obs[t])]
            acc = -1
            for prev in range(s_n):
                ll = tb.load(LL, (t - 1) * s_n + prev,
                             (last_ll[(t - 1) * s_n + prev],))
                lt = tb.load(TRANS, prev * s_n + curr)
                add = tb.op(T.FADD, ll, lt)
                acc = tb.op(T.ICMP, add, acc) if acc >= 0 else add
            le = tb.load(EMIS, curr * p.n_tokens + int(obs[t]), (lobs,))
            add = tb.op(T.FADD, acc, le)
            last_ll[t * s_n + curr] = tb.store(LL, t * s_n + curr, (add,))
            last_bp[t * s_n + curr] = tb.store(BP, t * s_n + curr, (acc,))
    # final argmin over llike[T-1] + backpointer chase
    acc = -1
    for s in range(s_n):
        ll = tb.load(LL, (t_n - 1) * s_n + s, (last_ll[(t_n - 1) * s_n + s],))
        acc = tb.op(T.ICMP, ll, acc) if acc >= 0 else ll
    state = int(np.argmin(llike[-1]))
    carry = tb.store(PATH, t_n - 1, (acc,))
    for t in range(t_n - 2, -1, -1):
        lb = tb.load(BP, (t + 1) * s_n + state,
                     (carry, last_bp[(t + 1) * s_n + state]))
        state = int(bptr_np[t + 1, state])
        carry = tb.store(PATH, t, (lb,))
    return tb.build()
