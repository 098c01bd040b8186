"""The traffic generator: the same seed gives the same traffic, every seed
the same sizes and gaps in another order, lengths that follow their
medians and clips, and arrivals at their rate."""
from statistics import NormalDist

import numpy as np

from benchcore import spec
from traffic import generate


def _mix(name):
    return spec.load_traffic(name)


def test_same_seed_same_requests_and_tokens():
    mix = _mix("chat")
    a = generate.serve_requests(mix, 300, 2**31 + 12345, rate=6.0)
    b = generate.serve_requests(mix, 300, 2**31 + 12345, rate=6.0)
    assert a == b
    assert generate.prompt_tokens(a[7], 2**31 + 12345, 64000) == \
        generate.prompt_tokens(b[7], 2**31 + 12345, 64000)


def test_seeds_share_sizes_and_gaps_in_another_order():
    mix = _mix("chat")
    n = 12 * generate.BLOCK               # whole blocks
    a = generate.serve_requests(mix, n, 1, rate=6.0)
    b = generate.serve_requests(mix, n, 2, rate=6.0)
    assert [r.prompt_len for r in a] != [r.prompt_len for r in b]
    assert sorted(r.prompt_len for r in a) == sorted(r.prompt_len for r in b)
    assert sorted(r.output_len for r in a) == sorted(r.output_len for r in b)
    assert abs(a[-1].offset_s - b[-1].offset_s) < 1e-9
    assert generate.prompt_tokens(a[0], 1, 64000) != \
        generate.prompt_tokens(a[0], 2, 64000)


def test_lengths_follow_median_and_clip():
    for name in ("chat", "docs"):
        mix = _mix(name)
        reqs = generate.serve_requests(mix, 64 * generate.BLOCK, 5)
        for key, attr in (("prompt", "prompt_len"), ("output", "output_len")):
            xs = np.array([getattr(r, attr) for r in reqs])
            assert xs.min() >= mix[key]["min"] and xs.max() <= mix[key]["max"]
            # a block's two middle quantiles straddle the median
            z = NormalDist().inv_cdf(0.5 + 0.5 / generate.BLOCK)
            off = mix[key]["median"] * (np.exp(mix[key]["sigma"] * z) - 1)
            assert abs(np.median(xs) - mix[key]["median"]) <= off + 1


def test_poisson_rate_and_backlog():
    mix = _mix("chat")
    reqs = generate.serve_requests(mix, 1000, 3, rate=8.0)
    offs = np.array([r.offset_s for r in reqs])
    assert np.all(np.diff(offs) > 0)
    assert abs(len(offs) / offs[-1] - 8.0) < 0.2
    assert all(r.offset_s == 0.0 for r in generate.serve_requests(mix, 10, 3))


def test_train_batches_repeat_and_differ():
    import torch

    mix = dict(_mix("pretrain"), batch=3, seq_len=8)
    a = generate.train_batch(mix, 9, 1, 100, "cpu")
    b = generate.train_batch(mix, 9, 1, 100, "cpu")
    c = generate.train_batch(mix, 9, 2, 100, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert len({tuple(r.tolist()) for r in a["tokens"]}) == 3


def test_blocks_hold_the_same_sizes_and_gaps():
    b = generate.BLOCK
    pairs = None
    for seed in (1, 2):
        reqs = generate.serve_requests(_mix("chat"), 4 * b, seed, rate=4.0)
        blocks = [reqs[i:i + b] for i in range(0, 4 * b, b)]
        got = [sorted((r.prompt_len, r.output_len) for r in blk)
               for blk in blocks]
        pairs = pairs or got[0]
        assert all(g == pairs for g in got)
        ends = [blk[-1].offset_s for blk in blocks]
        steps = np.diff([0.0] + ends)
        assert np.allclose(steps, steps[0])
        assert abs(steps[0] - b / 4.0) < 0.05 * b / 4.0
    # the fixed pairing: prompt and output lengths uncorrelated in rank
    rp = np.argsort(np.argsort([p for p, _ in pairs], kind="stable"))
    ro = np.argsort(np.argsort([o for _, o in pairs], kind="stable"))
    assert abs(np.corrcoef(rp, ro)[0, 1]) < 0.1
