"""The port's training data pipeline, draft vocabulary and feature shards
(`hsd_tpu_torch/train/data.py`, `draft_vocab.py`, `features.py`) against
the JAX package's, mirroring tests/test_train_data.py and
tests/test_draft_vocab.py.

* Batches, masks, segments, offline rows and d2t / t2d bit-equal to JAX's
  from the same inputs and `default_rng` seeds.
* A shard dumped by JAX's `dump_features` loads into the port's batches
  bit for bit and trains the port's offline step (v3 and v1) to JAX's loss
  within 1e-5 (the same f16 inputs; the forwards differ in the last f32
  bits).
* The noise functions by their law: shape and dtype, the identity at
  std 0, the moments, the uniform range, a generator's repeatability.
* tools/train_eagle.py --device cpu: dump, then train from the dump, in a
  subprocess for each head version.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.eval.benches import ChatTemplate as JChatTemplate
from hsd_tpu.eval.gsm8k import ByteTokenizer as JByteTokenizer
from hsd_tpu.train import data as jd
from hsd_tpu.train import draft_vocab as jdv
from hsd_tpu_torch.eval.benches import ChatTemplate
from hsd_tpu_torch.eval.gsm8k import ByteTokenizer
from hsd_tpu_torch.train import data as td
from hsd_tpu_torch.train import draft_vocab as tdv

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sharegpt_rows():
    return [
        {"id": "a", "conversations": [
            {"from": "human", "value": "What is two plus two?"},
            {"from": "gpt", "value": "Two plus two equals four."},
            {"from": "human", "value": "And times three?"},
            {"from": "gpt", "value": "Twelve."}]},
        {"id": "b", "conversations": [
            {"from": "gpt", "value": "stray leading reply"},   # dropped
            {"from": "human", "value": "Name a color."},
            {"from": "gpt", "value": "Blue."}]},
        {"id": "c", "conversations": [
            {"from": "human", "value": "only a question, no reply"}]},  # skip
        {"id": "d", "conversations": [
            {"from": "human", "value": "Hi"},
            {"from": "human", "value": "Hi again"}]},  # broken alternation
    ]


def _write(tmp_path, rows, name="conv.jsonl"):
    p = tmp_path / name
    p.write_text("\n".join(json.dumps(r) for r in rows))
    return str(p)


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"id": i, "conversations": [
        {"from": "human", "value": "q" * int(rng.integers(5, 300))},
        {"from": "gpt", "value": "a" * int(rng.integers(5, 400))}]}
        for i in range(n)]


def _batches_equal(a, b):
    assert len(a) == len(b)
    for (i1, m1), (i2, m2) in zip(a, b):
        assert i1.dtype == i2.dtype and m1.dtype == m2.dtype
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(m1, m2)


# --------------------------------------------------------------------------
# draft vocabulary (tests/test_draft_vocab.py)
# --------------------------------------------------------------------------

def test_build_draft_vocab():
    counts = np.array([5, 100, 2, 50, 80, 1, 60, 0])
    d2t, t2d = tdv.build_draft_vocab(counts, 4)
    assert t2d.sum() == 4
    np.testing.assert_array_equal(np.where(t2d)[0], [1, 3, 4, 6])
    np.testing.assert_array_equal(np.arange(4) + d2t, [1, 3, 4, 6])


def test_count_tokens():
    chunks = [np.array([[0, 1], [1, 2]]), np.array([2, 2])]
    np.testing.assert_array_equal(tdv.count_tokens(chunks, 4), [1, 2, 3, 0])


@pytest.mark.parametrize("V,Vd,seed", [(64, 16, 0), (1000, 300, 1),
                                       (128256, 32000, 2)])
def test_draft_vocab_bit_equal_to_jax(V, Vd, seed):
    """Counts with many ties (small ints): the stable order decides."""
    rng = np.random.default_rng(seed)
    chunks = [rng.integers(0, V, (4, 97)) for _ in range(3)]
    counts = tdv.count_tokens(chunks, V)
    np.testing.assert_array_equal(counts, jdv.count_tokens(chunks, V))
    for a, b in zip(tdv.build_draft_vocab(counts, Vd),
                    jdv.build_draft_vocab(counts, Vd)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# conversations (tests/test_train_data.py)
# --------------------------------------------------------------------------

def test_load_sharegpt_filters(tmp_path):
    path = _write(tmp_path, _sharegpt_rows())
    convs = td.load_sharegpt(path)
    assert convs == jd.load_sharegpt(path)
    assert len(convs) == 2
    for msgs in convs:
        assert msgs[0]["role"] == "system"
        roles = [m["role"] for m in msgs[1:]]
        assert roles == ["user", "assistant"] * (len(roles) // 2)
    # a json list file too
    p = tmp_path / "conv.json"
    p.write_text(json.dumps(_sharegpt_rows()))
    assert td.load_sharegpt(str(p), system="S") == jd.load_sharegpt(
        str(p), system="S")


@pytest.mark.parametrize("style", ["qwen", "llama3", "plain"])
def test_mask_marks_exactly_assistant_spans(style):
    tok = ByteTokenizer()
    msgs = [{"role": "system", "content": "Be brief."},
            {"role": "user", "content": "Say hello."},
            {"role": "assistant", "content": "Hello there!"},
            {"role": "user", "content": "Now say goodbye."},
            {"role": "assistant", "content": "Goodbye!"}]
    ids, mask = td.tokenize_conversation(tok, msgs, ChatTemplate(style=style),
                                         max_len=4096)
    jids, jmask = jd.tokenize_conversation(JByteTokenizer(), msgs,
                                           JChatTemplate(style=style),
                                           max_len=4096)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    assert ids.shape == mask.shape and mask[-1] == 0.0
    trained = tok.decode(ids[mask > 0].tolist())
    assert "Hello there!" in trained and "Goodbye!" in trained
    for frag in ("Be brief", "Say hello", "Now say", "user", "system"):
        assert frag not in trained
    if style == "qwen":
        assert "<|im_end|>" in trained
    if style == "llama3":
        assert "<|eot_id|>" in trained


class _BosAddingTokenizer(ByteTokenizer):
    """HF-style stub that auto-prepends a BOS id unless told not to."""

    BOS = 255

    def encode(self, s: str, add_special_tokens: bool = True):
        base = super().encode(s)
        return ([self.BOS] + base) if add_special_tokens else base


def test_segmentwise_equals_whole_render_with_bos_tokenizer():
    tok = _BosAddingTokenizer()
    msgs = [{"role": "user", "content": "Say hello."},
            {"role": "assistant", "content": "Hello there!"},
            {"role": "user", "content": "Again."},
            {"role": "assistant", "content": "Hello again!"}]
    for style in ("qwen", "llama3", "plain"):
        t = ChatTemplate(style=style)
        ids, mask = td.tokenize_conversation(tok, msgs, t, max_len=4096)
        whole = tok.encode("".join(s for s, _ in td._segments(t, msgs)),
                           add_special_tokens=False)
        np.testing.assert_array_equal(ids, np.asarray(whole, np.int32)[:4096])
        assert tok.BOS not in ids[mask > 0]


def test_segments_match_full_render():
    msgs = [{"role": "system", "content": "S"},
            {"role": "user", "content": "U1"},
            {"role": "assistant", "content": "A1"},
            {"role": "user", "content": "U2"},
            {"role": "assistant", "content": "A2"}]
    for style, open_hdr in (("qwen", "<|im_start|>assistant\n"),
                            ("llama3", "<|start_header_id|>assistant"
                                       "<|end_header_id|>\n\n"),
                            ("plain", None)):
        t = ChatTemplate(style=style)
        segs = td._segments(t, msgs)
        assert segs == jd._segments(JChatTemplate(style=style), msgs)
        if open_hdr is not None:
            assert t.render(msgs) == "".join(s for s, _ in segs) + open_hdr


def test_truncation_and_bucketing():
    tok = ByteTokenizer()
    msgs = [{"role": "system", "content": "x" * 50},
            {"role": "user", "content": "y" * 200},
            {"role": "assistant", "content": "z" * 500}]
    ids, mask = td.tokenize_conversation(tok, msgs, max_len=128)
    assert len(ids) == 128 and mask[-1] == 0.0
    assert td.pick_bucket(100) == 256 and td.pick_bucket(257) == 512
    assert td.pick_bucket(99999) == 2048
    b_ids, b_mask = td.collate([(ids, mask), (ids[:50], mask[:50])], 256)
    j_ids, j_mask = jd.collate([(ids, mask), (ids[:50], mask[:50])], 256)
    np.testing.assert_array_equal(b_ids, j_ids)
    np.testing.assert_array_equal(b_mask, j_mask)
    assert (b_mask[1, 50:] == 0).all() and (b_ids[1, 50:] == 0).all()
    long_msgs = [{"role": "system", "content": "s" * 300},
                 {"role": "user", "content": "u" * 300},
                 {"role": "assistant", "content": "a" * 20}]
    assert list(td.conversation_batches([long_msgs], tok, batch_size=1,
                                        buckets=(256,), seed=0)) == []


@pytest.mark.parametrize("seed,drop", [(3, False), (8, True)])
def test_conversation_batches_bit_equal_to_jax(tmp_path, seed, drop):
    tok = ByteTokenizer()
    convs = td.load_sharegpt(_write(tmp_path, _rows(11, seed)))
    kw = dict(batch_size=2, buckets=(256, 512, 1024), seed=seed,
              drop_remainder=drop)
    got = list(td.conversation_batches(convs, tok, **kw))
    _batches_equal(got, list(jd.conversation_batches(
        convs, JByteTokenizer(), **kw)))
    assert got
    for ids, mask in got:
        assert ids.shape[0] == 2 and ids.shape[1] in (256, 512, 1024)
        assert mask.shape == ids.shape and mask.sum() > 0


def test_epochs_reshuffle(tmp_path):
    rows = [{"id": i, "conversations": [
        {"from": "human", "value": f"question number {i} with padding"},
        {"from": "gpt", "value": f"answer number {i}"}]} for i in range(12)]
    path = _write(tmp_path, rows)
    kw = dict(batch_size=3, buckets=(256,), seed=0, system="Sys.")
    de = td.conversation_data_epochs(path, ByteTokenizer(), **kw)
    jde = jd.conversation_data_epochs(path, JByteTokenizer(), **kw)
    for e in (0, 1, 2):
        _batches_equal(list(de(e)), list(jde(e)))
    e0 = [ids.tobytes() for ids, _ in de(0)]
    e1 = [ids.tobytes() for ids, _ in de(1)]
    assert e0 == [ids.tobytes() for ids, _ in de(0)]
    assert e0 != e1


def test_noise_augmentation_law():
    h = torch.zeros((2, 64, 32))
    g = td.add_gaussian_noise(torch.Generator().manual_seed(0), h, std=0.5,
                              mean=0.1)
    assert g.shape == h.shape and g.dtype == h.dtype
    assert abs(float(g.mean()) - 0.1) < 0.02
    assert abs(float(g.std()) - 0.5) < 0.02
    u = td.add_uniform_noise(torch.Generator().manual_seed(1), h, std=0.2)
    # (U - 0.5) * std * 512 / T with T = 64: uniform on +-0.8
    half = 0.2 * 512 / 64 * 0.5
    assert float(u.abs().max()) <= half + 1e-6
    assert abs(float(u.mean())) < 0.02
    assert abs(float(u.std()) - 2 * half / 12 ** 0.5) < 0.02
    assert td.add_gaussian_noise(None, h) is h
    assert td.add_uniform_noise(None, h) is h
    again = td.add_gaussian_noise(torch.Generator().manual_seed(0), h,
                                  std=0.5, mean=0.1)
    assert torch.equal(g, again)
    hb = torch.ones((1, 8, 4), dtype=torch.bfloat16)
    assert td.add_uniform_noise(torch.Generator(), hb, std=0.1).dtype == \
        torch.bfloat16


def test_offline_example_shift_contract():
    T, D = 10, 8
    rng = np.random.default_rng(0)
    data = {"hidden_state": rng.normal(size=(T, D)),
            "input_ids": np.arange(T) + 5,
            "loss_mask": np.ones((T,))}
    ex = td.offline_example(data, max_len=8)
    jex = jd.offline_example(data, max_len=8)
    assert set(ex) == set(jex)
    for k in ex:
        assert ex[k].dtype == jex[k].dtype
        np.testing.assert_array_equal(ex[k], jex[k])
    np.testing.assert_array_equal(ex["input_ids"][:7], np.arange(6, 13))
    assert ex["input_ids"][7] == 0 and ex["loss_mask"][-1] == 0.0
    batch = td.collate_offline([ex, ex], bucket=16)
    jbatch = jd.collate_offline([jex, jex], bucket=16)
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k])
    assert batch["hidden_state_big"].shape == (2, 16, D)
    assert (batch["loss_mask"][:, 8:] == 0).all()


def test_list_data_files(tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "a.jsonl").write_text("{}")
    (tmp_path / "sub" / "b.jsonl").write_text("{}")
    (tmp_path / "sub" / "c.txt").write_text("x")
    files = td.list_data_files(str(tmp_path), suffix=".jsonl")
    assert [f.rsplit("/", 1)[1] for f in files] == ["a.jsonl", "b.jsonl"]
    assert td.list_data_files(str(tmp_path)) == jd.list_data_files(
        str(tmp_path))
    assert len(td.list_data_files(str(tmp_path))) == 3


# --------------------------------------------------------------------------
# the trainers, fed by the pipeline and by JAX-written shards
# --------------------------------------------------------------------------

def _tiny_models(vocab=256, layers=2):
    """The same tiny target and v3 head in both packages."""
    from hsd_tpu.config import ModelConfig as JCfg
    from hsd_tpu.models import init_params as j_init_params
    from hsd_tpu.models.eagle import EagleConfig as JECfg
    from hsd_tpu.models.eagle import init_eagle_params as j_init_eagle
    from hsd_tpu_torch import bridge
    from hsd_tpu_torch.config import ModelConfig
    from hsd_tpu_torch.models.eagle import EagleConfig

    geom = dict(vocab_size=vocab, hidden_size=32, intermediate_size=64,
                num_layers=layers, num_heads=4, num_kv_heads=2)
    ekw = dict(hidden_size=32, target_hidden_size=32, num_heads=4,
               num_kv_heads=2, vocab_size=vocab, draft_vocab_size=vocab,
               intermediate_size=64, rope_theta=10000.0)
    jt = j_init_params(JCfg.tiny(**geom), jax.random.PRNGKey(0))
    je = j_init_eagle(JECfg(dtype=jnp.float32, **ekw), jax.random.PRNGKey(1))
    return dict(jcfg=JCfg.tiny(**geom), cfg=ModelConfig.tiny(**geom),
                jecfg=JECfg(dtype=jnp.float32, **ekw),
                ecfg=EagleConfig(dtype=torch.float32, **ekw), jt=jt,
                tt=bridge.params_from_jax(jt), je=je,
                te=bridge.eagle_params_from_jax(je))


def test_pipeline_feeds_trainers_unchanged(tmp_path):
    """conversation jsonl -> data_epochs -> train_loop with both port
    steps on a tiny model; losses finite and steps advance."""
    import dataclasses
    from hsd_tpu_torch.engine.eagle_engine import default_feature_layers
    from hsd_tpu_torch.models.eagle import init_eagle_params_v1
    from hsd_tpu_torch.train import eagle1, eagle3
    from hsd_tpu_torch.train.loop import train_loop

    m = _tiny_models()
    rows = [{"id": i, "conversations": [
        {"from": "human", "value": f"ask {i}"},
        {"from": "gpt", "value": f"reply {i} ok"}]} for i in range(4)]
    de = td.conversation_data_epochs(_write(tmp_path, rows), ByteTokenizer(),
                                     batch_size=2, buckets=(256,), seed=0,
                                     system="Be brief.")
    tc = eagle3.TrainConfig(steps=2, total_steps=10, warmup_steps=1)
    losses = []

    def logged(step):
        def f(*a):
            st, met = step(*a)
            losses.append(float(met["loss"]))
            return st, met
        return f

    st3 = train_loop(eagle3.init_train_state(m["te"], tc),
                     logged(eagle3.make_train_step(
                         m["cfg"], m["ecfg"], tc,
                         default_feature_layers(m["cfg"]))),
                     m["tt"], de, num_epochs=1)
    assert st3.step == 2
    ecfg1 = dataclasses.replace(m["ecfg"], version=1)
    st1 = train_loop(eagle3.init_train_state(
        init_eagle_params_v1(ecfg1, seed=2, device="cpu"), tc),
        logged(eagle1.make_eagle1_train_step(m["cfg"], ecfg1, tc)),
        m["tt"], de, num_epochs=1)
    assert st1.step == 2
    assert len(losses) == 4 and np.isfinite(losses).all()


@pytest.mark.parametrize("version", [3, 1])
def test_jax_shard_trains_the_port(tmp_path, version):
    """JAX's dump_features writes the shard; the port's offline_data_epochs
    reads JAX's batches bit for bit, and the port's offline step on it gives
    the JAX offline step's loss and metrics within 1e-5."""
    import dataclasses
    from hsd_tpu.engine.eagle_engine import default_feature_layers
    from hsd_tpu.models.eagle import init_eagle_params_v1 as j_init_v1
    from hsd_tpu.train import eagle1 as je1
    from hsd_tpu.train import eagle3 as je3
    from hsd_tpu.train.features import dump_features as j_dump
    from hsd_tpu.train.features import offline_data_epochs as j_epochs
    from hsd_tpu_torch import bridge
    from hsd_tpu_torch.train import eagle1, eagle3
    from hsd_tpu_torch.train.features import (dump_features, offline_meta,
                                              offline_data_epochs)

    m = _tiny_models(vocab=64, layers=4)
    ids = np.random.default_rng(4).integers(0, 64, (2, 16)).astype(np.int32)
    lm = (np.random.default_rng(5).random((2, 16)) < 0.8).astype(np.float32)
    fl = default_feature_layers(m["jcfg"]) if version == 3 else None
    d = str(tmp_path / "jax")
    assert j_dump(m["jcfg"], m["jt"], [(ids, lm), (ids[::-1], lm)], d,
                  feature_layers=fl, version=version) == 2
    tb = list(offline_data_epochs(d, seed=1, device="cpu")(0))
    jb = list(j_epochs(d, seed=1)(0))
    for t, j in zip(tb, jb):
        assert set(t) == set(j)
        for k in t:
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    # the port's own dump of the same target: the same keys, dtypes, meta
    d2 = str(tmp_path / "port")
    dump_features(m["cfg"], m["tt"], [(ids, lm), (ids[::-1], lm)], d2,
                  feature_layers=fl, version=version, device="cpu")
    assert offline_meta(d2) == json.load(open(os.path.join(d, "meta.json")))
    with np.load(os.path.join(d, "shard_000001.npz")) as zj, \
            np.load(os.path.join(d2, "shard_000001.npz")) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype and zj[k].shape == zt[k].shape
            np.testing.assert_allclose(zt[k].astype(np.float32),
                                       zj[k].astype(np.float32), rtol=2e-3,
                                       atol=2e-3)

    tc = eagle3.TrainConfig(steps=3, lr=2e-3, warmup_steps=2, total_steps=50)
    jtc = je3.TrainConfig(**dataclasses.asdict(tc))
    if version == 3:
        je, jecfg, ecfg = m["je"], m["jecfg"], m["ecfg"]
        jstep = je3.make_train_step_offline(m["jcfg"], jecfg, jtc)
        tstep = eagle3.make_train_step_offline(m["cfg"], ecfg, tc)
    else:
        jecfg = dataclasses.replace(m["jecfg"], version=1)
        ecfg = dataclasses.replace(m["ecfg"], version=1)
        je = j_init_v1(jecfg, jax.random.PRNGKey(3))
        jstep = je1.make_eagle1_train_step_offline(m["jcfg"], jecfg, jtc)
        tstep = eagle1.make_eagle1_train_step_offline(m["cfg"], ecfg, tc)
    _, jm = jstep(je3.init_train_state(je, jtc), None, **jb[0])
    _, tm = tstep(eagle3.init_train_state(bridge.eagle_params_from_jax(je),
                                          tc), None, **tb[0])
    assert set(tm) == set(jm)
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * max(
            1.0, abs(float(jm[k]))), (k, float(tm[k]), float(jm[k]))


@pytest.mark.parametrize("ver", ["3", "1"])
def test_train_eagle_cli_offline_roundtrip(tmp_path, ver):
    """tools/train_eagle.py --device cpu --dump-features, then
    --features-dir: each head version trains from its dump with no target
    forward in the step."""
    conv = tmp_path / "conv.jsonl"
    conv.write_text("\n".join(json.dumps({"id": i, "conversations": [
        {"from": "human", "value": f"question {i} about colors?"},
        {"from": "gpt", "value": f"answer {i}: blue and green."}]})
        for i in range(4)))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    base = [sys.executable, "hsd_tpu_torch/tools/train_eagle.py",
            "--geometry", "tiny", "--batch-size", "2", "--buckets", "256",
            "--system", "hi", "--epochs", "1", "--device", "cpu",
            "--version", ver]
    fdir = str(tmp_path / f"fd{ver}")
    r = subprocess.run(base + ["--data", str(conv), "--dump-features", fdir],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["dumped_shards"] == 2
    ck = str(tmp_path / "ck")
    r2 = subprocess.run(base + ["--features-dir", fdir, "--ckpt-dir", ck],
                        capture_output=True, text=True, env=env, cwd=ROOT,
                        timeout=300)
    assert r2.returncode == 0, r2.stderr[-2000:]
    out2 = json.loads(r2.stdout.strip().splitlines()[-1])
    assert out2["final_step"] == 2 and out2["batches_per_epoch"] == 2
    assert os.path.isdir(os.path.join(ck, "state_2"))


def test_train_eagle_cli_refuses_a_mesh():
    """A --dp / --tp grid needs its processes (one process is a world of
    one); tests/test_torch_parallel_cli.py runs them."""
    from hsd_tpu_torch.tools import train_eagle
    for flag in (["--dp", "2"], ["--tp", "2"]):
        with pytest.raises(SystemExit, match="torchrun"):
            train_eagle.main(["--data", "x.jsonl", "--device", "cpu"] + flag)
