"""The traffic generator: repeatable from a seed, the stated ranges, the
shared prefix, the client count, and one set of lengths for every seed."""
import json
from pathlib import Path

import pytest

from perfbench.harness.traffic import Traffic, quantile_lengths

PKG = Path(__file__).resolve().parents[1]


# a mix with no shared prefix, which the repository's mixes do not show
UNSHARED = {"clients": 12, "warmup_completions": 4, "bucket": 128,
            "shared_prefix": 0,
            "prompt": {"median": 48, "sigma": 0.6, "min": 16, "max": 128},
            "output": {"median": 160, "sigma": 0.7, "min": 32, "max": 512},
            "pool": 40}


def mix(name):
    if name == "unshared":
        return UNSHARED
    return json.loads((PKG / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,vocab,lo,hi,out_lo,out_hi,prefix,clients", [
    ("gsm8k_8shot", 151936, 782, 826, 16, 106, 750, (120, 64)),
    ("unshared", 32000, 16, 128, 32, 512, 0, (12, 4))])
def test_ranges_prefix_and_clients(name, vocab, lo, hi, out_lo, out_hi,
                                   prefix, clients):
    m = mix(name)
    t = Traffic(m, 2 ** 31 + 3, vocab)
    assert (t.clients, t.warmup) == clients
    reqs = [t.request(i) for i in range(2 * m["pool"])]
    lens = [len(r.prompt) for r in reqs]
    assert lo <= min(lens) and max(lens) <= hi <= t.bucket
    assert sorted(lens[:m["pool"]]) == sorted(
        prefix + n for n in quantile_lengths(m["prompt"], m["pool"]))
    outs = [r.max_new for r in reqs]
    assert out_lo <= min(outs) and max(outs) == out_hi
    assert sorted(outs[:m["pool"]]) == sorted(
        quantile_lengths(m["output"], m["pool"]))
    # request i is length pair i mod pool, with its own tokens
    assert outs[:m["pool"]] == outs[m["pool"]:]
    assert reqs[0].prompt != reqs[m["pool"]].prompt
    assert all(r.prompt[:prefix] == reqs[0].prompt[:prefix] for r in reqs)
    assert len(t.prefix) == prefix
    ids = {x for r in reqs for x in r.prompt}
    assert min(ids) >= 10 and max(ids) < vocab - 512


def test_repeats_from_the_seed_and_differs_across_seeds():
    m = mix("gsm8k_8shot")
    a, b, c = (Traffic(m, s, 151936) for s in (5, 5, 6))
    assert [a.request(i) for i in range(50)] == [b.request(i)
                                                 for i in range(50)]
    assert [a.request(i) for i in range(50)] != [c.request(i)
                                                 for i in range(50)]


def test_every_seed_has_the_same_lengths_in_the_same_order():
    m = mix("gsm8k_8shot")
    a, b = Traffic(m, 1, 151936), Traffic(m, 2 ** 31 + 9, 151936)
    assert a.prompt_lens == b.prompt_lens
    assert a.output_lens == b.output_lens
    assert a.output_lens != sorted(a.output_lens)
    assert a.request(3).prompt != b.request(3).prompt


def test_quantile_lengths_median_and_clip():
    d = {"median": 100, "sigma": 0.5, "min": 60, "max": 150}
    v = quantile_lengths(d, 101)
    assert v[50] == 100 and min(v) == 60 and max(v) == 150
    assert v == sorted(v)
