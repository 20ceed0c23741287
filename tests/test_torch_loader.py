"""Port parity of models/loader.py against the JAX loader, on checkpoints
synthesized in the tests (tests/test_loader.py's writers; nothing is
downloaded).

Every test of tests/test_loader.py and test_moe.py's Mixtral loader test:
each fixture is loaded by both `load_hf`s, the parameters must be equal
bit for bit through the bridge, and the two forwards' float32 logits agree
within rtol = atol = 2e-3 (the port's logit tolerance,
tests/test_torch_model.py). Beside them: the port's safetensors reader
against safetensors.numpy.load_file (key for key, bit for bit, every dtype
it takes; others raise), a GPTQ Mixtral checkpoint with desc_act perms on
some experts, and `load_eagle_hf` on a synthesized EAGLE-3 head.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import numpy as stnp

from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.engine import init_cache as j_init_cache
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu.models import loader as jl
from hsd_tpu.models import transformer as jtr
from hsd_tpu.models.transformer import _rope as j_rope
from hsd_tpu.ops.linear import quantize as j_quantize
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import ModelConfig
from hsd_tpu_torch.engine.kvcache import init_cache
from hsd_tpu_torch.models import loader as tl
from hsd_tpu_torch.models import transformer as ttr
from hsd_tpu_torch.ops.linear import apply_linear, dequantize
from test_loader import _ref_dequant, _write_gptq_layer, _write_synthetic_ckpt

torch.set_num_threads(2)
TOL = dict(rtol=2e-3, atol=2e-3)
FIELDS = ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
          "num_heads", "num_kv_heads", "head_dim", "rope_theta",
          "rope_scaling", "rms_norm_eps", "tie_word_embeddings",
          "attention_bias", "eos_token_id", "num_experts",
          "num_experts_per_tok")


def _tcfg(jcfg, dtype=torch.float32):
    return ModelConfig(**{f: getattr(jcfg, f) for f in FIELDS}, dtype=dtype)


def _assert_same(got, want, where=""):
    """Equal structure, dtypes and bits: `want` is the bridged JAX value."""
    if want is None or got is None:
        assert got is None and want is None, where
    elif isinstance(want, tuple):
        assert type(got) is type(want), where
        for f in want._fields:
            _assert_same(getattr(got, f), getattr(want, f), f"{where}.{f}")
    elif isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    else:
        assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
        assert torch.equal(got, want), where


def _load_both(path, jcfg=None, dtype=torch.float32, **kw):
    """(jax cfg, jax params, port cfg, port params) of one checkpoint, the
    port's checked against the JAX's bit for bit."""
    tcfg = None if jcfg is None else _tcfg(jcfg, dtype)
    jcfg, jp = jl.load_hf(path, jcfg, **kw)
    tcfg, tp = tl.load_hf(path, tcfg, device="cpu", **kw)
    _assert_same(tp, bridge.params_from_jax(jp), "params")
    for f in FIELDS:
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    return jcfg, jp, tcfg, tp


def _logits_agree(jcfg, jp, tcfg, tp, T=6):
    toks = ((np.arange(T) % (jcfg.vocab_size - 2)) + 1).reshape(1, T)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    jlog, _ = jtr.forward(jcfg, jp, jnp.asarray(toks, jnp.int32),
                          j_init_cache(jcfg, 1, T + 2))
    tlog, _ = ttr.forward(tcfg, tp, torch.from_numpy(toks).long(),
                          init_cache(tcfg, 1, T + 2, "cpu"))
    assert np.isfinite(tlog.numpy()).all()
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    return tlog


def _save(t, path):
    stnp.save_file(t, str(path))


def test_read_safetensors_matches_safetensors_numpy(tmp_path):
    rng = np.random.default_rng(0)
    t = {"f64": rng.normal(size=(3, 5)), "f32": rng.normal(size=(7,))
         .astype(np.float32), "f16": rng.normal(size=(2, 3, 4))
         .astype(np.float16), "c64": (rng.normal(size=(4,)) + 1j)
         .astype(np.complex64), "bool": rng.random((5, 2)) > 0.5,
         "scalar": np.array(3.5, np.float32),
         "empty": np.zeros((0, 4), np.float32)}
    for dt in (np.int64, np.uint64, np.int32, np.uint32, np.int16,
               np.uint16, np.int8, np.uint8):
        info = np.iinfo(dt)
        t[np.dtype(dt).name] = rng.integers(info.min, info.max, (6, 3),
                                            dtype=dt, endpoint=True)
    _save(t, tmp_path / "a.safetensors")
    got = tl.read_safetensors(str(tmp_path / "a.safetensors"))
    want = stnp.load_file(str(tmp_path / "a.safetensors"))
    assert set(got) == set(want) == set(t)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k
    # the test writers' fixtures, key for key
    cfg = JCfg.tiny(vocab_size=128, hidden_size=256, intermediate_size=256,
                    num_layers=1, num_heads=4, num_kv_heads=4, head_dim=64)
    _write_synthetic_ckpt(str(tmp_path), cfg, quantized=4)
    fp = str(tmp_path / "model.safetensors")
    got, want = tl.read_safetensors(fp), stnp.load_file(fp)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k


def test_read_safetensors_rejects_other_dtypes(tmp_path):
    """A BF16 tensor (which safetensors.numpy reads only where ml_dtypes
    has taught numpy the type) and a header whose offsets do not fit the
    shape raise."""
    def write(header, payload):
        h = json.dumps(header).encode()
        h += b" " * (-len(h) % 8)
        with open(tmp_path / "x.safetensors", "wb") as f:
            f.write(len(h).to_bytes(8, "little") + h + payload)
        return str(tmp_path / "x.safetensors")
    fp = write({"w": {"dtype": "BF16", "shape": [2], "data_offsets": [0, 4]}},
               b"\0" * 4)
    with pytest.raises(ValueError, match="BF16"):
        tl.read_safetensors(fp)
    fp = write({"w": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}},
               b"\0" * 8)
    with pytest.raises(ValueError, match="data_offsets"):
        tl.read_safetensors(fp)


def test_unpack_roundtrip():
    rng = np.random.default_rng(1)
    for bits in (4, 8):
        per = 32 // bits
        codes = rng.integers(0, 1 << bits, (256, 64), dtype=np.uint32)
        packed = np.zeros((256 // per, 64), np.uint32)
        for j in range(per):
            packed |= codes[j::per] << (bits * j)
        p32 = packed.view(np.int32)
        out = tl._unpack_gptq_int32(torch.from_numpy(p32), bits)
        np.testing.assert_array_equal(out.numpy(), codes.astype(np.uint8))
        np.testing.assert_array_equal(out.numpy(),
                                      jl._unpack_gptq_int32(p32, bits))


def test_dense_checkpoint_forward(tmp_path):
    cfg = JCfg.tiny(vocab_size=128, num_layers=2)
    _write_synthetic_ckpt(str(tmp_path), cfg)
    jcfg, jp, tcfg, tp = _load_both(str(tmp_path), cfg)
    logits = _logits_agree(jcfg, jp, tcfg, tp)
    assert logits.shape == (1, 6, 128)


def test_config_from_hf(tmp_path):
    cfg = JCfg.tiny(vocab_size=128)
    _write_synthetic_ckpt(str(tmp_path), cfg)
    j, t = jl.config_from_hf(str(tmp_path)), tl.config_from_hf(str(tmp_path))
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    assert t.vocab_size == 128 and t.attention_bias
    assert t.dtype == torch.bfloat16 and not t.is_moe


@pytest.mark.parametrize("bits", [8, 4])
def test_gptq_checkpoint_dequant_matches_autogptq(tmp_path, bits):
    """auto-gptq: w = scale[g] * (code - (qzero[g] + 1)); the port's layer is
    the JAX loader's bit for bit and dequantizes to that matrix."""
    cfg = JCfg.tiny(vocab_size=128, hidden_size=256, intermediate_size=256,
                    num_layers=1, num_heads=4, num_kv_heads=4, head_dim=64)
    _write_synthetic_ckpt(str(tmp_path), cfg, quantized=bits)
    tt = tl._load_all_tensors(str(tmp_path))
    prefix = "model.layers.0.mlp.gate_proj"
    ql = tl._gptq_linear(tt, prefix, bits, device="cpu")
    _assert_same(ql, bridge.convert(jl._gptq_linear(
        jl._load_all_tensors(str(tmp_path)), prefix, bits, jnp.float32)))
    got = dequantize(ql, torch.float32).numpy()
    np.testing.assert_allclose(got, _ref_dequant(tt, prefix, bits),
                               rtol=1e-5, atol=1e-5)


def test_gptq_checkpoint_loads_stacked(tmp_path):
    cfg = JCfg.tiny(vocab_size=128, hidden_size=256, intermediate_size=384,
                    num_layers=2, num_heads=4, num_kv_heads=4, head_dim=64)
    _write_synthetic_ckpt(str(tmp_path), cfg, quantized=8)
    jcfg, jp, tcfg, tp = _load_both(str(tmp_path), cfg, quantized=8)
    assert tp.layers["wq"].qweight.shape == (2, 256, 256)
    _logits_agree(jcfg, jp, tcfg, tp, T=4)


def test_quantized_embedding_forward(tmp_path):
    """quantize_embed: the per-row int8 table, bit for bit as the JAX
    loader's, through the forward with an untied head."""
    cfg = dataclasses.replace(JCfg.tiny(vocab_size=128, hidden_size=256,
                                        intermediate_size=256, num_layers=2,
                                        num_heads=4, num_kv_heads=4,
                                        head_dim=64),
                              tie_word_embeddings=False)
    _write_synthetic_ckpt(str(tmp_path), cfg)
    jcfg, jp, tcfg, tp = _load_both(str(tmp_path), cfg, quantize_embed=True)
    assert isinstance(tp.embed, ttr.QuantizedEmbedding)
    _logits_agree(jcfg, jp, tcfg, tp)
    with pytest.raises(ValueError):
        tl.load_hf(str(tmp_path), dataclasses.replace(
            tcfg, tie_word_embeddings=True), quantize_embed=True,
            device="cpu")


def test_align_vocab_truncates_both_models():
    """align_vocab slices both models to the common vocab exactly as the
    JAX one does: dense tied, dense untied and quantized heads, logits on
    the surviving columns unchanged; an EOS past the cut raises."""
    cfg_d = JCfg.tiny(vocab_size=64)
    cfg_t = dataclasses.replace(JCfg.tiny(vocab_size=96),
                                tie_word_embeddings=False, eos_token_id=63)
    pd = j_init_params(cfg_d, jax.random.PRNGKey(0))
    pt = j_init_params(cfg_t, jax.random.PRNGKey(1))
    ptq = pt._replace(lm_head=j_quantize(pt.lm_head.astype(jnp.float32),
                                         group_size=64))
    toks = torch.from_numpy((np.arange(5) % 60)[None]).long()
    for head_t in (pt, ptq):
        jout = jl.align_vocab(cfg_d, pd, cfg_t, head_t)
        tout = tl.align_vocab(_tcfg(cfg_d), bridge.params_from_jax(pd),
                              _tcfg(cfg_t), bridge.params_from_jax(head_t))
        for jc, jpp, tc, tpp in ((jout[0], jout[1], tout[0], tout[1]),
                                 (jout[2], jout[3], tout[2], tout[3])):
            assert tc.vocab_size == jc.vocab_size == 64
            _assert_same(tpp, bridge.params_from_jax(jpp))
        base, _ = ttr.forward(_tcfg(cfg_t), bridge.params_from_jax(head_t),
                              toks, init_cache(_tcfg(cfg_t), 1, 8, "cpu"))
        out, _ = ttr.forward(tout[2], tout[3], toks,
                             init_cache(tout[2], 1, 8, "cpu"))
        assert out.shape[-1] == 64
        if head_t is pt:
            np.testing.assert_allclose(out.numpy(), base[..., :64].numpy(),
                                       rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        tl.align_vocab(_tcfg(cfg_d), bridge.params_from_jax(pd),
                       dataclasses.replace(_tcfg(cfg_t), eos_token_id=90),
                       bridge.params_from_jax(pt))


@pytest.mark.parametrize("bits", [8, 4])
def test_desc_act_dequant_matches_reference(bits):
    rng = np.random.default_rng(7)
    t = {}
    _write_gptq_layer(t, "x", 64, 256, bits, rng, desc_act=True)
    ql = tl._gptq_linear(t, "x", bits, device="cpu")
    assert ql.perm is not None and ql.perm.dtype == torch.int64
    _assert_same(ql, bridge.convert(jl._gptq_linear(t, "x", bits,
                                                    jnp.float32)))
    np.testing.assert_allclose(dequantize(ql, torch.float32).numpy(),
                               _ref_dequant(t, "x", bits),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_desc_act_apply_linear_matches_dense(bits):
    """apply_linear with a perm == x @ the original-order weight, at a
    kernel route's 2 rows and the dequantize route's 80."""
    rng = np.random.default_rng(8)
    t = {}
    _write_gptq_layer(t, "x", 64, 256, bits, rng, desc_act=True)
    ql = tl._gptq_linear(t, "x", bits, device="cpu")
    w = _ref_dequant(t, "x", bits).astype(np.float32)
    for n in (2, 80):
        x = rng.normal(0, 1, (n, 256)).astype(np.float32)
        got = apply_linear(ql, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, x @ w, rtol=2e-3, atol=2e-3)


def _write_desc_act_llama(tmp_path, rng, desc_layers):
    t = {"model.embed_tokens.weight":
         rng.normal(0, 0.02, (128, 256)).astype(np.float32),
         "model.norm.weight": np.ones((256,), np.float32)}
    for i in range(2):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = np.ones((256,), np.float32)
        t[p + "post_attention_layernorm.weight"] = np.ones((256,), np.float32)
        for nm in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                   "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
                   "mlp.down_proj"):
            _write_gptq_layer(t, p + nm, 256, 256, 8, rng,
                              desc_act=(i in desc_layers))
    _save(t, tmp_path / "model.safetensors")
    with open(tmp_path / "config.json", "w") as f:
        json.dump(dict(vocab_size=128, hidden_size=256,
                       intermediate_size=256, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=4,
                       head_dim=64, model_type="llama", rope_theta=1e4,
                       tie_word_embeddings=True, eos_token_id=0,
                       quantization_config=dict(
                           quant_method="gptq", bits=8, group_size=128,
                           sym=False, desc_act=True)), f)
    return t


def test_desc_act_stacked_layer_forward(tmp_path):
    """A desc_act checkpoint (layer 0 permuted, layer 1 in order: the
    identity fill) loads bit for bit as the JAX loader's and decodes."""
    cfg = JCfg.tiny(vocab_size=128, hidden_size=256, intermediate_size=256,
                    num_layers=2, num_heads=4, num_kv_heads=4, head_dim=64)
    t = _write_desc_act_llama(tmp_path, np.random.default_rng(9), (0,))
    jcfg, jp, tcfg, tp = _load_both(str(tmp_path), cfg)
    assert tp.layers["wq"].perm.shape == (2, 256)
    _logits_agree(jcfg, jp, tcfg, tp, T=5)
    x = np.random.default_rng(10).normal(0, 1, (1, 256)).astype(np.float32)
    got = apply_linear(tp.layers["wq"], torch.from_numpy(x), layer=0).numpy()
    want = x @ _ref_dequant(t, "model.layers.0.self_attn.q_proj", 8
                            ).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_gptq_v2_zero_convention():
    rng = np.random.default_rng(10)
    t = {}
    _write_gptq_layer(t, "x", 64, 256, 8, rng)
    for off in (1, 0):
        ql = tl._gptq_linear(t, "x", 8, zero_offset=off, device="cpu")
        _assert_same(ql, bridge.convert(jl._gptq_linear(
            t, "x", 8, jnp.float32, zero_offset=off)))
        np.testing.assert_allclose(dequantize(ql, torch.float32).numpy(),
                                   _ref_dequant(t, "x", 8, off),
                                   rtol=1e-5, atol=1e-5)


def test_symmetric_no_qzeros():
    rng = np.random.default_rng(11)
    t = {}
    _write_gptq_layer(t, "x", 64, 256, 8, rng, store_qzeros=False)
    ql = tl._gptq_linear(t, "x", 8, device="cpu")
    assert ql.zeros is None
    _assert_same(ql, bridge.convert(jl._gptq_linear(t, "x", 8, jnp.float32)))
    np.testing.assert_allclose(dequantize(ql, torch.float32).numpy(),
                               _ref_dequant(t, "x", 8), rtol=1e-5, atol=1e-5)


def test_ragged_g_idx_raises():
    rng = np.random.default_rng(12)
    t = {}
    _write_gptq_layer(t, "x", 64, 256, 8, rng, desc_act=True)
    t["x.g_idx"] = np.concatenate([t["x.g_idx"][:-1], [0]]).astype(np.int32)
    with pytest.raises(NotImplementedError):
        tl._gptq_linear(t, "x", 8, device="cpu")


def test_gptq_linear_defaults_to_the_card():
    """Like every entry point of the port, a layer converts onto the card
    unless the caller passes device='cpu'; with no card it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid")
    t = {}
    _write_gptq_layer(t, "x", 64, 256, 8, np.random.default_rng(13))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl._gptq_linear(t, "x", 8)


def test_read_quant_config(tmp_path):
    assert tl.read_quant_config(str(tmp_path)) is None
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"quantization_config": {
            "quant_method": "gptq", "bits": 4, "group_size": 64,
            "sym": True, "desc_act": True,
            "checkpoint_format": "gptq_v2"}}, f)
    qc = tl.read_quant_config(str(tmp_path))
    assert qc == jl.read_quant_config(str(tmp_path)) == {
        "bits": 4, "group_size": 64, "sym": True, "desc_act": True,
        "zero_offset": 0}
    os.unlink(tmp_path / "config.json")
    with open(tmp_path / "quantize_config.json", "w") as f:
        json.dump({"bits": 8, "group_size": 128, "desc_act": False}, f)
    qc = tl.read_quant_config(str(tmp_path))
    assert qc == jl.read_quant_config(str(tmp_path))
    assert qc["bits"] == 8 and qc["zero_offset"] == 1


def test_sharded_index_loading(tmp_path):
    _save({"w.a": np.ones((2, 2), np.float32)},
          tmp_path / "model-00001-of-00002.safetensors")
    _save({"w.b": np.zeros((3,), np.float32)},
          tmp_path / "model-00002-of-00002.safetensors")
    _save({"stray": np.ones((1,), np.float32)},
          tmp_path / "extra.safetensors")
    idx = {"weight_map": {"w.a": "model-00001-of-00002.safetensors",
                          "w.b": "model-00002-of-00002.safetensors"}}
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump(idx, f)
    t = tl._load_all_tensors(str(tmp_path))
    assert set(t) == {"w.a", "w.b"}
    assert t["w.a"].tobytes() == np.ones((2, 2), np.float32).tobytes()
    os.unlink(tmp_path / "model-00002-of-00002.safetensors")
    with pytest.raises(FileNotFoundError):
        tl._load_all_tensors(str(tmp_path))


def test_untied_config_missing_lm_head_falls_back_tied(tmp_path):
    cfg = dataclasses.replace(JCfg.tiny(vocab_size=128, num_layers=2),
                              tie_word_embeddings=False)
    _write_synthetic_ckpt(str(tmp_path),
                          dataclasses.replace(cfg, tie_word_embeddings=True))
    jcfg, jp, tcfg, tp = _load_both(str(tmp_path), cfg)
    assert tcfg.tie_word_embeddings and tp.lm_head is None
    logits = _logits_agree(jcfg, jp, tcfg, tp, T=4)
    assert logits.shape[-1] == 128


def test_rope_scaling_llama3(tmp_path):
    """config_from_hf reads rope_type=llama3 as the JAX one does, and the
    port's rotation with it equals the JAX `_rope`."""
    cfgj = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                num_hidden_layers=1, num_attention_heads=2,
                num_key_value_heads=2, model_type="llama",
                rope_theta=500000.0, tie_word_embeddings=True,
                eos_token_id=0,
                rope_scaling=dict(rope_type="llama3", factor=8.0,
                                  low_freq_factor=1.0, high_freq_factor=4.0,
                                  original_max_position_embeddings=8192))
    with open(tmp_path / "config.json", "w") as f:
        json.dump(cfgj, f)
    c = tl.config_from_hf(str(tmp_path))
    assert c.rope_scaling == (8.0, 1.0, 4.0, 8192)
    assert c.rope_scaling == jl.config_from_hf(str(tmp_path)).rope_scaling
    d, theta = 32, 500000.0
    x = np.random.default_rng(3).normal(size=(1, 2, 1, d)).astype(np.float32)
    pos = np.array([[1, 4096]])
    want = np.asarray(j_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                             theta, c.rope_scaling))
    got = ttr.rope_apply(torch.from_numpy(x), ttr.rope_tables(
        torch.from_numpy(pos), d, theta, c.rope_scaling)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _write_mixtral(tmp_path, rng, D=16, F=24, E=4, L=2, V=64, H=4, Hkv=2,
                   bits=None, desc=()):
    """A Mixtral-layout checkpoint (block_sparse_moe.gate, experts.{e}.w1
    / w3 / w2), dense f32 or GPTQ with desc_act g_idx on the (layer,
    expert, name) matrices listed in `desc`."""
    hd = D // H
    t = {"model.embed_tokens.weight": rng.normal(size=(V, D)),
         "lm_head.weight": rng.normal(size=(V, D)),
         "model.norm.weight": np.ones(D)}

    def mat(name, dout, din, desc_act=False):
        if bits:
            _write_gptq_layer(t, name, dout, din, bits, rng,
                              desc_act=desc_act)
        else:
            t[name + ".weight"] = rng.normal(size=(dout, din)) * 0.2
    for i in range(L):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = np.ones(D)
        t[p + "post_attention_layernorm.weight"] = np.ones(D)
        mat(p + "self_attn.q_proj", H * hd, D)
        mat(p + "self_attn.k_proj", Hkv * hd, D)
        mat(p + "self_attn.v_proj", Hkv * hd, D)
        mat(p + "self_attn.o_proj", D, H * hd)
        t[p + "block_sparse_moe.gate.weight"] = rng.normal(size=(E, D))
        for e in range(E):
            q = p + f"block_sparse_moe.experts.{e}."
            mat(q + "w1", F, D, (i, e, "w1") in desc)
            mat(q + "w3", F, D, (i, e, "w3") in desc)
            mat(q + "w2", D, F, (i, e, "w2") in desc)
    t = {k: (v if v.dtype in (np.int32, np.float16) else
             np.asarray(v, np.float32)) for k, v in t.items()}
    _save(t, tmp_path / "model.safetensors")
    cfgj = dict(model_type="mixtral", vocab_size=V, hidden_size=D,
                intermediate_size=F, num_hidden_layers=L,
                num_attention_heads=H, num_key_value_heads=Hkv,
                rope_theta=1e6, rms_norm_eps=1e-5, tie_word_embeddings=False,
                num_local_experts=E, num_experts_per_tok=2, eos_token_id=2)
    if bits:
        cfgj["quantization_config"] = dict(quant_method="gptq", bits=bits,
                                           group_size=128, sym=False,
                                           desc_act=bool(desc))
    with open(tmp_path / "config.json", "w") as f:
        json.dump(cfgj, f)
    return t


def test_mixtral_checkpoint_loader(tmp_path):
    """The dense Mixtral layout: router [L, D, E] (the transpose of the
    stored [E, D]), expert stacks [L, E, in, out], as the JAX loader."""
    t = _write_mixtral(tmp_path, np.random.default_rng(3))
    jcfg, jp, tcfg, tp = _load_both(str(tmp_path), dtype=torch.bfloat16)
    assert tcfg.num_experts == 4 and tcfg.num_experts_per_tok == 2
    assert tp.layers["gate"].shape == (2, 16, 4)
    assert tp.layers["gate"].dtype == torch.float32
    assert tp.layers["wgate"].shape == (2, 4, 16, 24)
    assert tp.layers["wdown"].shape == (2, 4, 24, 16)
    np.testing.assert_array_equal(
        tp.layers["gate"][0].numpy(),
        t["model.layers.0.block_sparse_moe.gate.weight"].T)
    _logits_agree(jcfg, jp, tcfg, tp)


def test_mixtral_gptq_checkpoint_loader(tmp_path):
    """A 4-bit GPTQ Mixtral (v1 zero points) with desc_act g_idx on one
    expert's w2 in each layer: packed expert stacks [L, E, in/2, out] with
    an identity-filled [L, E, in] perm, bit for bit as the JAX loader's,
    and each expert's product equals its original-order dequantized
    weight."""
    rng = np.random.default_rng(4)
    t = _write_mixtral(tmp_path, rng, D=256, F=256, V=128, bits=4,
                       desc={(0, 1, "w2"), (1, 3, "w2")})
    jcfg, jp, tcfg, tp = _load_both(str(tmp_path))
    w2 = tp.layers["wdown"]
    assert w2.qweight.shape == (2, 4, 128, 256) and w2.perm.shape == \
        (2, 4, 256)
    assert tp.layers["wgate"].perm is None
    assert torch.equal(w2.perm[0, 0], torch.arange(256))
    assert not torch.equal(w2.perm[0, 1], torch.arange(256))
    _logits_agree(jcfg, jp, tcfg, tp)
    x = rng.normal(size=(3, 256)).astype(np.float32)
    for l, e in ((0, 1), (1, 3), (1, 0)):
        name = f"model.layers.{l}.block_sparse_moe.experts.{e}.w2"
        got = apply_linear(w2.layer(l).layer(e), torch.from_numpy(x))
        np.testing.assert_allclose(
            got.numpy(), x @ _ref_dequant(t, name, 4).astype(np.float32),
            rtol=2e-3, atol=2e-3)


def test_mixtral_perm_in_a_later_layer_only(tmp_path):
    """A perm on layer 1's experts only: the port fills layer 0 with the
    identity and keeps it. (The JAX loader's `stack_experts` takes the
    perm only when layer 0's stack has one, so it drops layer 1's.)"""
    rng = np.random.default_rng(5)
    t = _write_mixtral(tmp_path, rng, D=256, F=256, V=128, L=2, bits=4,
                       desc={(1, 2, "w1")})
    cfg, p = tl.load_hf(str(tmp_path), device="cpu")
    w1 = p.layers["wgate"]
    assert w1.perm is not None and w1.perm.shape == (2, 4, 256)
    assert jl.load_hf(str(tmp_path))[1].layers["wgate"].perm is None
    x = rng.normal(size=(2, 256)).astype(np.float32)
    name = "model.layers.1.block_sparse_moe.experts.2.w1"
    got = apply_linear(w1.layer(1).layer(2), torch.from_numpy(x))
    np.testing.assert_allclose(
        got.numpy(), x @ _ref_dequant(t, name, 4).astype(np.float32),
        rtol=2e-3, atol=2e-3)


def _write_eagle3_head(path, rng, D=32, Dt=32, V=64, Vd=48, H=4, Hkv=2,
                       F=64, dtype=np.float16, maps=True):
    hd = D // H
    t = {"fc.weight": rng.normal(size=(D, 3 * Dt)),
         "midlayer.input_layernorm.weight": rng.normal(size=(D,)),
         "midlayer.hidden_norm.weight": rng.normal(size=(D,)),
         "midlayer.self_attn.q_proj.weight": rng.normal(size=(H * hd, 2 * D)),
         "midlayer.self_attn.k_proj.weight":
             rng.normal(size=(Hkv * hd, 2 * D)),
         "midlayer.self_attn.v_proj.weight":
             rng.normal(size=(Hkv * hd, 2 * D)),
         "midlayer.self_attn.o_proj.weight": rng.normal(size=(D, H * hd)),
         "midlayer.post_attention_layernorm.weight": rng.normal(size=(D,)),
         "midlayer.mlp.gate_proj.weight": rng.normal(size=(F, D)),
         "midlayer.mlp.up_proj.weight": rng.normal(size=(F, D)),
         "midlayer.mlp.down_proj.weight": rng.normal(size=(D, F)),
         "norm.weight": rng.normal(size=(D,)),
         "lm_head.weight": rng.normal(size=(Vd, D))}
    t = {k: (v * 0.1).astype(dtype) for k, v in t.items()}
    if maps:
        t["d2t"] = rng.integers(0, V - Vd, (Vd,)).astype(np.int64)
        t["t2d"] = rng.random(V) > 0.3
    os.makedirs(path, exist_ok=True)
    _save(t, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(hidden_size=D, target_hidden_size=Dt,
                       num_attention_heads=H, num_key_value_heads=Hkv,
                       vocab_size=V, draft_vocab_size=Vd,
                       intermediate_size=F, rope_theta=10000.0,
                       rms_norm_eps=1e-5), f)
    return t


@pytest.mark.parametrize("maps", [True, False])
def test_load_eagle_hf_matches_jax(tmp_path, maps):
    rng = np.random.default_rng(6)
    _write_eagle3_head(str(tmp_path), rng, maps=maps)
    embed = rng.normal(size=(64, 32)).astype(np.float32)
    jp = jl.load_eagle_hf(str(tmp_path), jnp.asarray(embed),
                          dtype=jnp.float32)
    tp = tl.load_eagle_hf(str(tmp_path), torch.from_numpy(embed),
                          dtype=torch.float32, device="cpu")
    _assert_same(tp, bridge.eagle_params_from_jax(jp))
    assert tp.fc.shape == (96, 32) and tp.lm_head.shape == (32, 48)
    assert tp.d2t.dtype == torch.int64 and tp.t2d.dtype == torch.bool
