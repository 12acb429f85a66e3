"""The plain reference of ``machsuite-nw``: MachSuite nw/needwun
(Needleman-Wunsch global alignment, ALEN = BLEN = 128) traced as the
benchmark's own copy of the generator.

MachSuite's fill of the score matrix ``M[(ALEN+1)*(BLEN+1)]`` (int32)
and the traceback pointers ``ptr`` (one byte a word): each cell loads
one character of either sequence and its up-left, up and left
neighbours of ``M`` (unit and row-pitch strides), each load waiting on
the store that wrote that word, and stores its score and its pointer.
The sequences drawn from the seed set the scores, not the trace: every
address and dependence follows the loop alone.  The traceback is left
out (``machsuite-nw.json``'s ``assumed``).
"""
from chipbench.reference import trace as T


def gen_trace(params: dict, seed: int) -> T.Trace:
    alen = int(params["alen"])
    blen = int(params["blen"])
    row_w = alen + 1
    tb = T.TraceBuilder("nw")
    SEQA = tb.declare_array("seqA", 1)
    SEQB = tb.declare_array("seqB", 1)
    M = tb.declare_array("M", 4)
    PTR = tb.declare_array("ptr", 1)
    writer: dict = {}        # index of M -> the store that last wrote it
    for a_idx in range(alen + 1):                         # init_row
        writer[a_idx] = tb.store(M, a_idx)
    for b_idx in range(1, blen + 1):                      # init_col
        writer[b_idx * row_w] = tb.store(M, b_idx * row_w)
    for b_idx in range(1, blen + 1):                      # fill_out
        row_up, row = (b_idx - 1) * row_w, b_idx * row_w
        for a_idx in range(1, alen + 1):                  # fill_in
            score = tb.op(T.ICMP, tb.load(SEQA, a_idx - 1),
                          tb.load(SEQB, b_idx - 1))
            up_left = tb.load(M, row_up + a_idx - 1,
                              (writer[row_up + a_idx - 1],))
            up = tb.load(M, row_up + a_idx, (writer[row_up + a_idx],))
            left = tb.load(M, row + a_idx - 1, (writer[row + a_idx - 1],))
            s_up_left = tb.op(T.IADD, up_left, score)
            s_up = tb.op(T.IADD, up)
            s_left = tb.op(T.IADD, left)
            best = tb.op(T.ICMP, tb.op(T.ICMP, s_up_left, s_up), s_left)
            writer[row + a_idx] = tb.store(M, row + a_idx, (best,))
            tb.store(PTR, row + a_idx, (best,))
    return tb.build()
