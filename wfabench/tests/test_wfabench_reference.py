"""The plain reference: pywfa's golden pair, the DP against the plain
wavefront aligner, the judge of op strings, and both against the program
on the CPU."""
import numpy as np
import pytest
import torch

from wfabench.reference import cigar, dp, wfa

GOLDEN = (b"TCTTTACTCGCGCGTTGGAGAAATACAATAGT",
          b"TCTATACTGCGCGTTTGGAGAAATAAAATAGT")


def cigarstring(ops: str) -> str:
    out, run = [], 1
    for i in range(1, len(ops) + 1):
        if i < len(ops) and ops[i] == ops[i - 1]:
            run += 1
        else:
            out.append(f"{run}{ops[i - 1]}")
            run = 1
    return "".join(out)


def random_pairs(seed, n, max_len=60, rate=0.1):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    pats, txts = [], []
    for _ in range(n):
        p = bytes(alphabet[rng.integers(0, 4, int(rng.integers(1, max_len)))])
        t = bytearray()
        for c in p:
            r = rng.random()
            if r < rate / 2:
                continue
            if r < rate:
                t.append(int(alphabet[rng.integers(4)]))
            t.append(c if rng.random() > rate else int(alphabet[rng.integers(4)]))
        pats.append(p)
        txts.append(bytes(t) or b"A")
    return pats, txts


def test_golden_pair():
    score, ops, _ = wfa.align(*GOLDEN)
    assert score == -24
    assert cigarstring(ops) == "3M1X4M1D7M1I9M1X6M"
    assert dp.affine_costs([GOLDEN[0]], [GOLDEN[1]], 4, 6, 2)[0] == 24
    ok, cost = cigar.judge_ops([GOLDEN[0]], [GOLDEN[1]], [ops.encode()],
                               4, 6, 2)
    assert ok[0] and cost[0] == 24


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dp_equals_the_wavefront_aligner(seed):
    pats, txts = random_pairs(seed, 120)
    costs = dp.affine_costs(pats, txts, 4, 6, 2, block_cells=512)
    for p, t, c in zip(pats, txts, costs):
        score, ops, _ = wfa.align(p, t)
        assert -score == c
    ok, judged = cigar.judge_ops(
        pats, txts, [wfa.align(p, t)[1].encode() for p, t in zip(pats, txts)],
        4, 6, 2)
    assert ok.all() and (judged == costs).all()


def test_judge_catches_wrong_ops():
    p, t = GOLDEN
    ops = wfa.align(p, t)[1]
    bad = [ops.replace("X", "M", 1), ops[:-1], ops.replace("M", "X", 1),
           ops.replace("D", "I", 1), ops + "?"]
    ok, _ = cigar.judge_ops([p] * len(bad), [t] * len(bad),
                            [b.encode() for b in bad], 4, 6, 2)
    assert not ok.any()
    # a valid alignment at a higher cost is caught by its cost
    longer = "D" * len(p) + "I" * len(t)
    ok, cost = cigar.judge_ops([p], [t], [longer.encode()], 4, 6, 2)
    assert ok[0] and cost[0] == 2 * 6 + 2 * (len(p) + len(t))


def test_int8_is_wrong_where_int32_is_right():
    pats, txts = random_pairs(5, 64, max_len=150, rate=0.04)
    exact = dp.affine_costs(pats, txts, 4, 6, 2)
    low = dp.affine_costs(pats, txts, 4, 6, 2, dtype=torch.int8)
    assert (low != exact).mean() > 0.5


@pytest.mark.parametrize("span", ["end-to-end", "ends-free"])
def test_program_agrees_with_the_reference_on_the_cpu(span):
    """The program's plain versions (device="cpu") answer the scores the
    DP gives and the op strings the wavefront aligner gives, byte for
    byte (pywfa's defaults: ends-free with no free ends is end to end)."""
    import pywfa_tpu_torch as P
    pats, txts = random_pairs(11, 96)
    res = P.BatchWavefrontAligner(device="cpu", span=span).align(pats, txts)
    costs = dp.affine_costs(pats, txts, 4, 6, 2)
    for p, t, r, c in zip(pats, txts, res, costs):
        assert r.status == 0 and r.score == -c
        assert r.ops == wfa.align(p, t)[1]
