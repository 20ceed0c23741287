"""The one traffic generator: it reads a mix's parameters (a JSON file under
`traffic/`) and makes a closed loop's requests from the run's seed.

A mix:
  clients             clients of the closed loop; each sends its next
                      request when its last completes, with no think time
  warmup_completions  completions before the measured window opens
  bucket              the prompt bucket (prompts are left-padded to it)
  shared_prefix       tokens of one prefix every prompt starts with (0: none)
  prompt, output      {"median", "sigma", "min", "max"}: lognormal token
                      counts (the prompt's after the shared prefix)
  pool                the number of (prompt, output) length pairs

The lengths are the same for every seed, in the same order: the
lognormal's quantiles at (i + 0.5) / pool, clipped to [min, max] and
rounded, shuffled once by a fixed permutation (one for prompts, another
for outputs). A seed draws the token ids, uniformly from [10, vocab -
512), which holds no EOS or special id of the configurations here (by the
seed and the request's index; the shared prefix by the seed alone), never
the work's sizes: with the order drawn from the seed, runs of different
seeds spread 14-29% in tpot_p90_ms against 1-6% for runs of one seed.
Request i of the loop is pair i mod pool.
"""
from __future__ import annotations

import math
import statistics
from typing import List, NamedTuple

import numpy as np

ID_LOW, ID_TOP_MARGIN = 10, 512
ORDER_SEED = 0


class Req(NamedTuple):
    index: int
    prompt: List[int]
    max_new: int


def quantile_lengths(dist: dict, n: int) -> List[int]:
    """n lengths at the lognormal's quantiles (i + 0.5) / n, clipped."""
    nd = statistics.NormalDist()
    mu, sigma = math.log(dist["median"]), dist["sigma"]
    return [int(min(dist["max"], max(dist["min"], round(
        math.exp(mu + sigma * nd.inv_cdf((i + 0.5) / n)))))) for i in range(n)]


class Traffic:
    def __init__(self, mix: dict, seed: int, vocab_size: int):
        self.seed = int(seed)
        self.clients = int(mix["clients"])
        self.warmup = int(mix["warmup_completions"])
        self.bucket = int(mix["bucket"])
        self.high = vocab_size - ID_TOP_MARGIN
        n = int(mix["pool"])
        order = np.random.default_rng(ORDER_SEED)
        self.prompt_lens = [quantile_lengths(mix["prompt"], n)[i]
                            for i in order.permutation(n)]
        self.output_lens = [quantile_lengths(mix["output"], n)[i]
                            for i in order.permutation(n)]
        k = int(mix.get("shared_prefix", 0))
        self.prefix = np.random.default_rng([self.seed, 0]).integers(
            ID_LOW, self.high, k).tolist()
        if k + max(self.prompt_lens) > self.bucket:
            raise ValueError("a prompt does not fit the bucket")

    def request(self, i: int) -> Req:
        j = i % len(self.prompt_lens)
        rng = np.random.default_rng([self.seed, 1, i])
        own = rng.integers(ID_LOW, self.high, self.prompt_lens[j]).tolist()
        return Req(i, self.prefix + own, self.output_lens[j])

    @property
    def max_new(self) -> int:
        return max(self.output_lens)
