"""End-to-end EAGLE losslessness of the port (the counterpart of
`tests/test_eagle_lossless.py`): the token stream of eagenerate (trie draft
+ typical / trie-HSD verification) must be distributed as target AR
sampling. The JAX file's models (bridged from its seeds), N = 6000 trials,
T = 2 tokens and TV bound 0.13 (`tests/test_eagle_lossless.py:64`).

The trials run batched: every trial shares the prompt, so one prefill
(`make_eagle_block`'s) is replicated over N slots and each slot samples its
own root from the prefill's last logits; one `make_eagle_pool` step then
commits at least two tokens in every slot, which is what
`make_eagle_generate` commits in its first block on that slot's draws. The
AR side is one batched loop of `transformer.forward` over the N rows, two
tokens deep. Trials whose first token is EOS are dropped on both sides, as
the JAX file's length filter drops them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.models import eagle as jeagle
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, ModelConfig
from hsd_tpu_torch.engine.eagle_engine import make_eagle_block, make_eagle_pool
from hsd_tpu_torch.engine.kvcache import KVCache, init_cache
from hsd_tpu_torch.models import eagle as teagle
from hsd_tpu_torch.models import transformer
from hsd_tpu_torch.ops.sampling import processor, sample

torch.set_num_threads(2)

V = 16
GEOM = dict(vocab_size=V, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2, eos_token_id=V - 1)
JTCFG = JCfg.tiny(**GEOM)
TCFG = ModelConfig.tiny(**GEOM)
EGEOM = dict(hidden_size=32, target_hidden_size=32, num_heads=4,
             num_kv_heads=2, vocab_size=V, draft_vocab_size=V,
             intermediate_size=64, top_k=2, depth=2, total_tokens=5,
             rope_theta=10000.0)
JECFG = jeagle.EagleConfig(**EGEOM, dtype=jnp.float32)
ECFG = teagle.EagleConfig(**EGEOM, dtype=torch.float32)
PROMPT = torch.tensor([1, 2, 3, 4, 5, 6])
P = 6
N = 6000
T = 2


def _joint(toks, T):
    flat = np.zeros(len(toks), np.int64)
    for j in range(T):
        flat = flat * V + toks[:, j]
    return np.bincount(flat, minlength=V ** T) / len(toks)


def _tv(a, b):
    return 0.5 * float(np.abs(a - b).sum())


def _models():
    pt = bridge.params_from_jax(j_init_params(JTCFG, jax.random.PRNGKey(0)))
    pe = bridge.eagle_params_from_jax(
        jeagle.init_eagle_params(JECFG, jax.random.PRNGKey(1)))
    return pt, pe


def _eagle_trials(mode, pt, pe, eng, gen):
    """The first T tokens of N eagenerate trials: [N, T] and their kept
    mask."""
    prefill, _, _, _ = make_eagle_block(TCFG, ECFG, eng, mode=mode)
    pool_block = make_eagle_pool(TCFG, ECFG, eng, mode=mode)
    tokens, length, tc, ekv, feat = prefill(pt, pe, PROMPT, P, gen)
    # each trial's root: a draw from the prefill's last-position law
    logits, _ = transformer.forward(TCFG, pt, PROMPT[None],
                                    init_cache(TCFG, 1, P, "cpu"))
    probs = processor(eng.temperature)(logits[:, -1]).expand(N, V)
    rep = lambda t: t.expand(N, *t.shape[1:]).contiguous()
    tokens = rep(tokens)
    tokens[:, P] = sample(probs, gen)
    n1 = ECFG.total_tokens + 1
    pad = lambda t: torch.nn.functional.pad(
        t.expand(-1, N, -1, -1, -1), (0, 0, 0, 0, 0, n1)).contiguous()
    pool = KVCache(k=pad(tc.k), v=pad(tc.v), length=0,
                   start=tc.start.expand(N).contiguous())
    ekv = teagle.EagleKV(*(rep(f) if isinstance(f, torch.Tensor)
                           and f.dim() else f for f in ekv))
    tokens, lengths, _, _, _, _, _, _ = pool_block(
        pt, pe, tokens, rep(length), pool, ekv, rep(feat), gen)
    assert int(lengths.min()) >= P + T
    toks = tokens[:, P:P + T].numpy()
    return toks, toks[:, 0] != TCFG.eos_token_id


def _ar_trials(pt, eng, gen):
    """N target AR samples, T tokens deep, in one batched loop."""
    temp = processor(eng.temperature)
    cache = init_cache(TCFG, N, P + T, "cpu")
    _, cache = transformer.forward(TCFG, pt, PROMPT[None, :-1].expand(N, -1),
                                   cache, skip_head=True)
    tok = PROMPT[-1:].expand(N)
    out = []
    for _ in range(T):
        logits, cache = transformer.forward(TCFG, pt, tok[:, None], cache)
        tok = sample(temp(logits[:, 0]), gen)
        out.append(tok)
    toks = torch.stack(out, 1).numpy()
    return toks, toks[:, 0] != TCFG.eos_token_id


@pytest.mark.parametrize("mode", ["typical", "hsd"])
def test_eagle_stream_matches_ar(mode):
    pt, pe = _models()
    eng = EngineConfig(max_new_tokens=T + 1, temperature=1.0)
    with torch.no_grad():
        toks, ok = _eagle_trials(mode, pt, pe, eng,
                                 torch.Generator().manual_seed(2))
        toks_ar, ok_ar = _ar_trials(pt, eng, torch.Generator().manual_seed(3))
    emp = _joint(toks[ok], T)
    want = _joint(toks_ar[ok_ar], T)
    assert ok.mean() > 0.8 and ok_ar.mean() > 0.8
    tv = _tv(emp, want)
    # the JAX file's bound. Two empirical joints of 256 cells at N = 6000:
    # two AR draws of this target differ by TV 0.111-0.118 (seeds 3-5), and
    # the EAGLE streams of both modes over seeds 2, 7, 8 lie at 0.109-0.122
    # from each of them; taking the next token of a block by argmax in
    # place of a draw lands at 0.80
    assert tv < 0.13, f"eagle {mode}: TV {tv:.4f}"
