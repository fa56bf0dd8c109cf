"""The register lists of the IVF ring kernel (csrc/ivf_scan_tma.cuh, list
classes kListWarp2 and kListWarp4, 32 < k <= 128), emulated lane by lane
in numpy: the bitonic sort of a warp's 32 entries (``sort32``), Batcher's
merge of 32 sorted entries into a sorted list of 32 L (``merge32``), and
the last CTA's merge of the CTAs' sorted lists (held entries merged 32 at
a time, lists closed once an entry misses entry k - 1, the rest streamed
past their windows). Each result must equal a plain sort of the same
entries in (score desc, key asc) order exactly (tolerance: none; ties in
score broken by the key, the (NEG_INF, 0) fills included)."""

import numpy as np
import pytest

NEG_INF = float(np.finfo(np.float32).min)
LANE = np.arange(32)


def better(a_s, a_i, b_s, b_i):
    """(a_s, a_i) ranks before (b_s, b_i): higher score, then lower key."""
    return (a_s > b_s) | ((a_s == b_s) & (a_i < b_i))


def exchange(s, i, mask, keep_better):
    """Each lane and the lane ``mask`` away: keep the better entry where
    ``keep_better``, else the worse (``__shfl_xor_sync`` on both words)."""
    os, oi = s[LANE ^ mask], i[LANE ^ mask]
    take = np.where(keep_better, better(os, oi, s, i), better(s, i, os, oi))
    return np.where(take, os, s), np.where(take, oi, i)


def sort32(s, i):
    size = 2
    while size <= 32:
        stride = size // 2
        while stride:
            s, i = exchange(s, i, stride, ((LANE & stride) == 0) == ((LANE & size) == 0))
            stride //= 2
        size *= 2
    return s, i


def merge32(ls, li, cs, ci):
    """ls, li [L, 32]: entry 32 r + lane in [r, lane]."""
    ls, li = ls.copy(), li.copy()
    n = ls.shape[0]
    os, oi = cs[31 - LANE], ci[31 - LANE]
    take = better(os, oi, ls[n - 1], li[n - 1])
    ls[n - 1], li[n - 1] = np.where(take, os, ls[n - 1]), np.where(take, oi, li[n - 1])
    h = n // 2
    while h:
        for r in range(n):
            if r & h == 0:
                sw = better(ls[r + h], li[r + h], ls[r], li[r])
                ls[r], ls[r + h] = np.where(sw, ls[r + h], ls[r]), np.where(sw, ls[r], ls[r + h])
                li[r], li[r + h] = np.where(sw, li[r + h], li[r]), np.where(sw, li[r], li[r + h])
        h //= 2
    for stride in (16, 8, 4, 2, 1):
        for r in range(n):
            ls[r], li[r] = exchange(ls[r], li[r], stride, (LANE & stride) == 0)
    return ls, li


def ordered(s, i):
    """(score desc, key asc)."""
    o = np.lexsort((i, -s))
    return s[o], i[o]


def entries(rng, n, live, n_scores=40):
    """n entries: ``live`` with scores from a small set (ties) and distinct
    keys, the rest the (NEG_INF, 0) fill."""
    s = np.full(n, NEG_INF, np.float32)
    i = np.zeros(n, np.int64)
    s[:live] = rng.integers(0, n_scores, live).astype(np.float32) / 8
    i[:live] = rng.choice(1 << 20, live, replace=False) + 1
    return s, i


@pytest.mark.parametrize("regs", [1, 2, 4])
@pytest.mark.parametrize("seed", range(6))
def test_sort32_and_merge32_keep_the_best_in_order(regs, seed):
    rng = np.random.default_rng(seed * 10 + regs)
    for live_list in (0, 5, 32 * regs):
        for live_new in (0, 1, 17, 32):
            ls, li = entries(rng, 32 * regs, live_list)
            ls, li = ordered(ls, li)
            cs, ci = entries(rng, 32, live_new)
            perm = rng.permutation(32)
            cs, ci = cs[perm], ci[perm]
            ss, si = sort32(cs, ci)
            np.testing.assert_array_equal(np.stack(ordered(cs, ci)), np.stack([ss, si]))
            gs, gi = merge32(ls.reshape(regs, 32), li.reshape(regs, 32), ss, si)
            ws, wi = ordered(np.concatenate([ls, cs]), np.concatenate([li, ci]))
            np.testing.assert_array_equal(gs.reshape(-1), ws[: 32 * regs])
            np.testing.assert_array_equal(gi.reshape(-1), wi[: 32 * regs])


def list_entry(ls, li, e):
    return ls[e // 32, e % 32], li[e // 32, e % 32]


def merge_lists(lists_s, lists_i, k, regs, window, lists_per_lane=9):
    """The last CTA's merge for one query (Int8/Int4 alike): the window's
    positions list by list, each lane holding one offered entry and the
    warp merging the 32 it holds when a lane would take a second; then the
    lists still open past their windows, 32 entries at a time."""
    n_cta = len(lists_s)
    ls = np.full((regs, 32), NEG_INF, np.float32)
    li = np.zeros((regs, 32), np.int64)
    ts, ti = np.float32(NEG_INF), 0
    hs = np.full(32, NEG_INF, np.float32)
    hi = np.zeros(32, np.int64)
    held = np.zeros(32, bool)
    opened = np.zeros((lists_per_lane, 32), bool)
    for m in range(lists_per_lane):
        opened[m] = LANE + 32 * m < n_cta
    wk = min(window, k)
    n_offers = wk * lists_per_lane
    for o in range(n_offers + 1):
        e, m = divmod(o, lists_per_lane)
        cs = np.full(32, NEG_INF, np.float32)
        ci = np.zeros(32, np.int64)
        ins = np.zeros(32, bool)
        if o < n_offers:
            for lane in np.flatnonzero(opened[m]):
                lst = lane + 32 * m
                cs[lane], ci[lane] = lists_s[lst][e], lists_i[lst][e]
                ins[lane] = better(cs[lane], ci[lane], ts, ti)
                opened[m, lane] = ins[lane]
        if (held & (ins | (o == n_offers))).any():
            ss, si = sort32(hs, hi)
            ls, li = merge32(ls, li, ss, si)
            ts, ti = list_entry(ls, li, k - 1)
            hs, hi, held = np.full(32, NEG_INF, np.float32), np.zeros(32, np.int64), held & False
        hs, hi = np.where(ins, cs, hs), np.where(ins, ci, hi)
        held |= ins
    for m in range(lists_per_lane):
        for lane in range(32):
            if not (opened[m, lane] and wk < k):
                continue
            lst, base = lane + 32 * m, wk
            while True:
                cs = np.full(32, NEG_INF, np.float32)
                ci = np.zeros(32, np.int64)
                n = max(0, min(32, k - base))
                cs[:n], ci[:n] = lists_s[lst][base : base + n], lists_i[lst][base : base + n]
                ins = (LANE < n) & better(cs, ci, ts, ti)
                if not ins.any():
                    break
                cs, ci = np.where(ins, cs, NEG_INF), np.where(ins, ci, 0)
                ls, li = merge32(ls, li, cs.astype(np.float32), ci)
                ts, ti = list_entry(ls, li, k - 1)
                base += 32
                if not ins.all() or base >= k:
                    break
    return ls.reshape(-1)[:k], li.reshape(-1)[:k]


# (k, window, CTAs, how the live entries spread over the lists)
MERGE_CASES = [(64, 4, 264, "clustered"), (64, 4, 264, "spread"), (64, 8, 40, "clustered"),
               (33, 4, 288, "spread"), (128, 4, 100, "clustered"), (100, 8, 7, "one-list"),
               (64, 4, 264, "empty"), (40, 4, 264, "few-live")]


@pytest.mark.parametrize("k, window, n_cta, kind", MERGE_CASES)
def test_register_merge_equals_a_sort_of_the_lists(k, window, n_cta, kind):
    rng = np.random.default_rng(k + window + n_cta)
    regs = 2 if k <= 64 else 4
    lists_s, lists_i = [], []
    key = 1
    for c in range(n_cta):
        live = {"clustered": k if c < 6 else rng.integers(0, 8),
                "spread": rng.integers(0, k + 1), "one-list": k if c == 3 else 0,
                "empty": 0, "few-live": 1 if c % 50 == 0 else 0}[kind]
        s, i = entries(rng, k, int(live))
        if kind == "clustered" and c < 6:
            s[:live] += 100  # the CTAs that scanned the query's cluster
        i[i > 0] += key
        key += 1 << 21
        s, i = ordered(s, i)
        lists_s.append(s)
        lists_i.append(i)
    gs, gi = merge_lists(lists_s, lists_i, k, regs, window)
    ws, wi = ordered(np.concatenate(lists_s), np.concatenate(lists_i))
    np.testing.assert_array_equal(gs, ws[:k])
    np.testing.assert_array_equal(gi, wi[:k])
