"""The serving slice of the PyTorch port against the JAX package, on the
CPU: gpt_like's prefill and paged decode steps, offline ``generate`` and
``LLMEngine``, at a tiny width. Weights are drawn once from a seeded
numpy RNG, set into the JAX model and carried into the port with
``from_jax_params``.
"""
import os
import re
import subprocess
import sys
import time

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import numpy as mxnp
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.gluon.model_zoo.generation import generate as jgenerate
from mxnet_tpu.ops.nn import kv_cache_quantize as jquantize
from mxnet_tpu.serving.llm import LLMEngine as JEngine
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo.generation import generate as tgenerate
from mxnet_tpu_torch.serving.llm import LLMEngine as TEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=53, units=32, hidden_size=64, num_layers=2,
           num_heads=4, max_length=96)


def _params(seed):
    """Seeded numpy weights under the reference's parameter names."""
    jnet = jbert.gpt_like(dropout=0.0, **CFG)
    jnet.initialize()
    rng = onp.random.RandomState(seed)
    params = {}
    for name, p in jnet.collect_params().items():
        if name.endswith(".gamma"):
            v = 1.0 + 0.1 * rng.randn(*p.shape)
        elif name.endswith((".beta", ".bias")):
            v = 0.1 * rng.randn(*p.shape)
        else:
            v = 0.2 * rng.randn(*p.shape)
        params[name] = v.astype(onp.float32)
        p.set_data(params[name])
    return jnet, params


def _models(seed):
    jnet, params = _params(seed)
    tnet = tbert.gpt_like(device="cpu", **CFG)
    from_jax_params(params, tnet)
    return jnet, tnet


def _t(a):
    return torch.from_numpy(onp.array(a))


def test_state_dict_names_are_the_reference_names():
    jnet, params = _params(0)
    tnet = tbert.gpt_like(device="cpu", **CFG)
    sd = tnet.state_dict()
    assert set(sd) == set(params)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: v.shape for k, v in params.items()}
    assert "encoder.layer0.attn.qkv.weight" in sd and "pos_embed" in sd
    bad = dict(params)
    bad.pop("pos_embed")
    with pytest.raises(MXNetError, match="missing"):
        from_jax_params(bad, tnet)
    bad = dict(params, **{"pos_embed": params["pos_embed"][:10]})
    with pytest.raises(MXNetError, match="shape"):
        from_jax_params(bad, tnet)


def test_prefill_and_paged_decode_logits_match_jax():
    """One decode_step (the prefill path) and one decode_step_paged: the
    port's logits within 1e-4 of the JAX model's (f32 caches)."""
    jnet, tnet = _models(1)
    rng = onp.random.RandomState(2)
    prompt = rng.randint(0, 53, (2, 7)).astype(onp.int32)
    jck, jcv = jnet.init_cache(2, 16, dtype="float32")
    jlg, _, _ = jnet.decode_step(mxnp.array(prompt), jck, jcv,
                                 mxnp.array(onp.int32(0)))
    tck, tcv = tnet.init_cache(2, 16, dtype="float32")
    with torch.no_grad():
        tlg, _, _ = tnet.decode_step(_t(prompt), tck, tcv, 0)
    onp.testing.assert_allclose(tlg.numpy(), jlg.asnumpy(), rtol=1e-4,
                                atol=1e-4)

    nb, bs = 9, 4
    pool = (rng.randn(2, nb, 4, bs, 8) * 0.5).astype(onp.float32)
    toks = onp.array([[7], [11], [3]], onp.int32)
    bt = onp.array([[0, 1, 8, 8], [2, 3, 4, 8], [5, 8, 8, 8]], onp.int32)
    pos = onp.array([2, 9, 0], onp.int32)
    jlg, jpk, _ = jnet.decode_step_paged(
        mxnp.array(toks), mxnp.array(pool), mxnp.array(pool),
        mxnp.array(bt), mxnp.array(pos))
    tpk, tpv = _t(pool), _t(pool)
    with torch.no_grad():
        tlg, tpk, _ = tnet.decode_step_paged(_t(toks), tpk, tpv, _t(bt),
                                             _t(pos))
    onp.testing.assert_allclose(tlg.numpy(), jlg.asnumpy(), rtol=1e-4,
                                atol=1e-4)
    onp.testing.assert_allclose(tpk.numpy(), jpk.asnumpy(), rtol=1e-4,
                                atol=1e-4)


@pytest.mark.parametrize("fused", ["0", "1"])
def test_int8_paged_decode_step_close_to_jax(monkeypatch, fused):
    """int8 pools: one paged decode step's logits within 2e-4 of the JAX
    model's, through the port's unfused path and through its fused path
    (fused_decode_step on plain versions) — the mirror of
    test_fused_decode_int8_pool_close_to_unfused."""
    jnet, tnet = _models(3)
    rng = onp.random.RandomState(4)
    pool = onp.asarray(jax.jit(jquantize)(
        jnp.asarray(rng.randn(2, 9, 4, 4, 8).astype(onp.float32))))
    toks = onp.array([[7], [11]], onp.int32)
    bt = onp.array([[0, 1, 8, 8], [2, 3, 8, 8]], onp.int32)
    pos = onp.array([2, 5], onp.int32)
    monkeypatch.setenv("MXNET_TPU_LLM_FUSED_DECODE", "0")
    jlg, _, _ = jnet.decode_step_paged(
        mxnp.array(toks), mxnp.array(pool), mxnp.array(pool),
        mxnp.array(bt), mxnp.array(pos))
    monkeypatch.setenv("MXNET_TPU_LLM_FUSED_DECODE", fused)
    with torch.no_grad():
        tlg, _, _ = tnet.decode_step_paged(_t(toks), _t(pool), _t(pool),
                                           _t(bt), _t(pos))
    onp.testing.assert_allclose(tlg.numpy(), jlg.asnumpy(), rtol=2e-4,
                                atol=2e-4)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_fused_path_agrees_with_unfused_on_cpu(monkeypatch, kv):
    """The port's fused decode path (K5a/K4/K5b wrappers, plain versions
    on the CPU) against its unfused path: logits within 2e-5 (f32 pools)
    and 2e-4 (int8 pools, a near-tie rounding may flip one step)."""
    _, tnet = _models(5)
    rng = onp.random.RandomState(6)
    if kv == "int8":
        pool = onp.asarray(jax.jit(jquantize)(
            jnp.asarray(rng.randn(2, 9, 4, 4, 8).astype(onp.float32))))
    else:
        pool = rng.randn(2, 9, 4, 4, 8).astype(onp.float32)
    toks = onp.array([[1], [2], [3]], onp.int32)
    bt = onp.array([[0, 1, 8, 8], [2, 3, 4, 8], [5, 6, 7, 8]], onp.int32)
    pos = onp.array([6, 13, 10], onp.int32)
    outs = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("MXNET_TPU_LLM_FUSED_DECODE", mode)
        with torch.no_grad():
            outs[mode] = tnet.decode_step_paged(
                _t(toks), _t(pool), _t(pool), _t(bt), _t(pos))[0].numpy()
    tol = 2e-4 if kv == "int8" else 2e-5
    onp.testing.assert_allclose(outs["1"], outs["0"], rtol=tol, atol=tol)


def test_generate_tokens_identical_to_jax():
    """Greedy offline generate: identical tokens (f32 and int8 caches)."""
    jnet, tnet = _models(7)
    rng = onp.random.RandomState(8)
    prompt = rng.randint(0, 53, (2, 6)).astype(onp.int32)
    for kv in ("float32", "int8"):
        want = jgenerate(jnet, prompt, max_new_tokens=8, greedy=True,
                         kv_cache_dtype=kv).asnumpy()
        got = tgenerate(tnet, prompt, max_new_tokens=8, greedy=True,
                        kv_cache_dtype=kv, device="cpu").numpy()
        onp.testing.assert_array_equal(got, want)


def test_engine_tokens_identical_to_jax_engine():
    """Three prompts submitted together to the port's LLMEngine on the
    CPU and to the JAX LLMEngine (f32 pools, 4 lanes, block 4): the
    greedy tokens are identical, and the port's pool returns to full."""
    jnet, tnet = _models(9)
    rng = onp.random.RandomState(10)
    reqs = [(rng.randint(0, 53, (p,)).astype(onp.int32), n)
            for p, n in ((5, 9), (9, 6), (3, 11))]
    kw = dict(max_running=4, block_size=4, max_context=48,
              kv_cache_dtype="float32")
    with JEngine(jnet, **kw) as jeng:
        hs = [jeng.submit(p, n) for p, n in reqs]
        want = [onp.asarray(h.wait(timeout=120)) for h in hs]
    with TEngine(tnet, device="cpu", **kw) as teng:
        hs = [teng.submit(p, n) for p, n in reqs]
        got = [onp.asarray(h.wait(timeout=120)) for h in hs]
        st = teng.stats()
    for g, w in zip(got, want):
        onp.testing.assert_array_equal(g, w)
    assert st["counters"]["completed"] == 3
    assert st["pool_blocks_free"] == st["pool_blocks_total"]


def test_engine_bounds_requests_on_the_host():
    """Positions and token ids are bounded before any device work."""
    _, tnet = _models(11)
    with TEngine(tnet, device="cpu", max_running=2, block_size=4,
                 max_context=16) as eng:
        with pytest.raises(ValueError, match="max_context"):
            eng.submit(onp.arange(10) % 53, 7)
        with pytest.raises(ValueError, match="token ids"):
            eng.submit(onp.array([1, 53]), 2)
        out = eng.generate(onp.array([1, 2, 3]), 4)
    assert out.dtype == onp.int32 and out.shape == (4,)


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without device=, gpt_like, generate and LLMEngine target gpu(0),
    and so do BERT's and the vision zoo's initialize() and a
    pretrained=True load; with no card they raise instead of running on
    the CPU."""
    from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tbert.gpt_like(**CFG)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tbert.BERTForPretraining(tbert.bert_base(
            vocab_size=50, units=16, hidden_size=32, num_layers=1,
            num_heads=2, max_length=8), vocab_size=50).initialize()
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tvision.get_model("mobilenet0.25", classes=4).initialize()
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tvision.resnet18_v1(pretrained=True, root=str(tmp_path))
    assert not os.listdir(tmp_path)       # raised before generating
    _, tnet = _models(12)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        TEngine(tnet)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tgenerate(tnet, onp.ones((1, 3), onp.int32), 2)


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of the port or chip_smoke.py names jax or mxnet_tpu; with
    both blocked, every module of the port imports, a tiny CPU engine
    serves, plain and with a draft model and the prefix cache (the chain
    hashes, the suffix-prefill, draft and verify programs), the same
    model takes a train step through the loss and the
    Trainer, the front door (mx.np, a deferred RMSNorm/Dense stack,
    rtc.TorchModule) runs, a tiny resnet18_v1(thumbnail=True) takes
    a train step through the Trainer, and the training front door runs:
    a scheduled NAG Trainer over a list of Parameters, a composite
    metric, CTCLoss, and an Updater's state blob round trip; the BERT
    builders and every vision module import, a tiny BERTForPretraining
    runs with a valid_length, and resnet18_v1(pretrained=True)
    generates the model store's weights to the manifest's hash; the
    serving options' modules (the quantizer, telemetry, resilience, the
    manifest, the codec, the blob store, the spill tier) import, and an
    int8-weight engine with the host and disk spill tiers serves a
    session that is evicted and re-attached, with a trace id, a step
    hook and a saved warmup manifest, and beam_search runs."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|mxnet_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirs, names in os.walk(os.path.join(ROOT, "mxnet_tpu_torch")):
        if "_build" in dirs:            # compiled kernels, no sources
            dirs.remove("_build")
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mxnet_tpu'] = None\n"
        "import numpy as np, torch\n"
        "import mxnet_tpu_torch\n"
        "from mxnet_tpu_torch.gluon.model_zoo.bert import gpt_like\n"
        "from mxnet_tpu_torch.serving import LLMEngine\n"
        "torch.manual_seed(0)\n"
        "net = gpt_like(device='cpu', vocab_size=41, units=32,"
        " hidden_size=64, num_layers=2, num_heads=4, max_length=64)\n"
        "with LLMEngine(net, device='cpu', max_running=2,"
        " block_size=4) as eng:\n"
        "    out = eng.generate(np.array([1, 2, 3]), 5)\n"
        "assert out.shape == (5,) and (out >= 0).all() and (out < 41).all()\n"
        "from mxnet_tpu_torch.serving.kv_hash import chain_hashes\n"
        "from mxnet_tpu_torch.gluon.model_zoo.generation import (\n"
        "    paged_spec_draft_program, paged_spec_verify_program,\n"
        "    paged_suffix_prefill_program)\n"
        "draft = gpt_like(device='cpu', vocab_size=41, units=32,"
        " hidden_size=64, num_layers=1, num_heads=4, max_length=64)\n"
        "with LLMEngine(net, device='cpu', max_running=2, block_size=4,"
        " draft_model=draft, draft_k=2, prefix_cache=True) as eng:\n"
        "    for p in ([1, 2, 3, 4, 5, 6, 7, 8, 9], [1, 2, 3, 4, 5, 6, 7, 8]):\n"
        "        spec = eng.generate(np.array(p), 5)\n"
        "        assert spec.shape == (5,)\n"
        "    st = eng.stats()\n"
        "assert st['prefix_cache']['hit_requests'] == 1\n"
        "assert st['speculative']['proposed'] > 0\n"
        "assert len(chain_hashes(np.arange(9), 4)) == 2\n"
        "from mxnet_tpu_torch import autograd\n"
        "from mxnet_tpu_torch.gluon import Trainer\n"
        "from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss\n"
        "from mxnet_tpu_torch.ops.kernels import cross_entropy, "
        "flash_attention\n"
        "x = torch.randint(0, 41, (2, 9))\n"
        "tr = Trainer(dict(net.named_parameters()), 'adam')\n"
        "with autograd.record():\n"
        "    loss = SoftmaxCrossEntropyLoss()(net(x)[:, :-1], x[:, 1:])\n"
        "autograd.backward(loss)\n"
        "tr.step(2)\n"
        "assert loss.shape == (2,) and torch.isfinite(loss).all()\n"
        "import pkgutil, importlib\n"
        "for m in pkgutil.walk_packages(mxnet_tpu_torch.__path__,"
        " 'mxnet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from mxnet_tpu_torch import np as mnp, rtc\n"
        "from mxnet_tpu_torch.gluon import nn\n"
        "ffn = nn.HybridSequential()\n"
        "ffn.add(nn.RMSNorm(), nn.Dense(8, flatten=False))\n"
        "ffn.initialize(device='cpu')\n"
        "h = ffn(mnp.random.normal(size=(2, 3, 4), device='cpu'))\n"
        "assert h.shape == (2, 3, 8)\n"
        "k = rtc.TorchModule('def f(x):\\n    return x * 2\\n')\n"
        "assert k.get_kernel('f').launch([h]).shape == h.shape\n"
        "from mxnet_tpu_torch.gluon.model_zoo import vision\n"
        "rn = vision.resnet18_v1(thumbnail=True, classes=5)\n"
        "rn.initialize(device='cpu')\n"
        "rtr = Trainer(rn.collect_params(), 'sgd',"
        " {'learning_rate': 0.05, 'momentum': 0.9})\n"
        "with autograd.record():\n"
        "    rl = SoftmaxCrossEntropyLoss()(rn(torch.rand(2, 3, 8, 8)),"
        " torch.tensor([1, 4]))\n"
        "autograd.backward(rl)\n"
        "rtr.step(2)\n"
        "assert rl.shape == (2,) and torch.isfinite(rl).all()\n"
        "from mxnet_tpu_torch import lr_scheduler, optimizer\n"
        "from mxnet_tpu_torch.gluon import loss as gloss, metric\n"
        "sch = lr_scheduler.MultiFactorScheduler(step=[1], factor=0.1,"
        " warmup_steps=1)\n"
        "ftr = Trainer(list(rn.collect_params().values()), 'nag',"
        " {'learning_rate': 0.05, 'lr_scheduler': sch})\n"
        "with autograd.record():\n"
        "    logits = rn(torch.rand(2, 3, 8, 8))\n"
        "    fl = SoftmaxCrossEntropyLoss()(logits, torch.tensor([1, 4]))\n"
        "autograd.backward(fl)\n"
        "ftr.step(2)\n"
        "acc = metric.create(['acc', metric.TopKAccuracy(2), 'loss'])\n"
        "acc.update([torch.tensor([1, 4])], [logits.detach()])\n"
        "assert len(acc.get()[1]) == 3\n"
        "ctc = gloss.CTCLoss()(torch.randn(2, 5, 4), torch.tensor([[1, 2],"
        " [3, 3]]))\n"
        "assert ctc.shape == (2,) and torch.isfinite(ctc).all()\n"
        "up = optimizer.get_updater(optimizer.create('lamb'))\n"
        "wt = torch.ones(3, 2)\n"
        "up(0, torch.full((3, 2), 0.5), wt)\n"
        "up.set_states(up.get_states())\n"
        "up(0, torch.full((3, 2), 0.5), wt)\n"
        "assert torch.isfinite(wt).all() and not torch.equal(wt,"
        " torch.ones(3, 2))\n"
        "import tempfile\n"
        "from mxnet_tpu_torch.gluon.model_zoo import model_store\n"
        "from mxnet_tpu_torch.gluon.model_zoo.bert import (BERTModel,"
        " BERTForPretraining, bert_base, bert_large)\n"
        "from mxnet_tpu_torch.gluon.model_zoo.vision import (alexnet,"
        " densenet, inception, mobilenet, resnet, squeezenet, vgg)\n"
        "bp = BERTForPretraining(bert_base(vocab_size=50, units=16,"
        " hidden_size=32, num_layers=1, num_heads=2, max_length=8),"
        " vocab_size=50)\n"
        "bp.initialize(device='cpu')\n"
        "mlm, nsp = bp(torch.randint(0, 50, (2, 8)), None,"
        " torch.tensor([8, 5]))\n"
        "assert mlm.shape == (2, 8, 50) and nsp.shape == (2, 2)\n"
        "with tempfile.TemporaryDirectory() as root:\n"
        "    r18 = vision.resnet18_v1(pretrained=True, root=root,"
        " device='cpu')\n"
        "    assert model_store._file_sha256(model_store.get_model_file("
        "'resnet18_v1', root)) == model_store._MODEL_SHA256['resnet18_v1']\n"
        "from mxnet_tpu_torch import aot, contrib, io, resilience, telemetry\n"
        "from mxnet_tpu_torch.serving import kv_codec, kv_spill\n"
        "from mxnet_tpu_torch.gluon.model_zoo.generation import beam_search\n"
        "ticks = []\n"
        "with tempfile.TemporaryDirectory() as spill_dir:\n"
        "    with LLMEngine(net, device='cpu', max_running=2, block_size=4,"
        " max_context=24, num_blocks=8, weight_dtype='int8',"
        " prefix_cache=True, kv_spill=True, kv_spill_bytes=2048,"
        " kv_spill_dir=spill_dir, step_hook=lambda: ticks.append(1)) as eng:\n"
        "        sess = np.arange(1, 13) % 41\n"
        "        first = eng.generate(sess, 3, trace_id='t-guard')\n"
        "        for s in range(3):\n"
        "            eng.generate((np.arange(12) * (s + 2) + 1) % 41, 1)\n"
        "        again = eng.generate(sess, 3)\n"
        "        st = eng.stats()\n"
        "        eng.save_warmup_manifest(spill_dir + '/m.json')\n"
        "    assert (first == again).all() and ticks\n"
        "    assert st['kv_spill']['reattach_bytes'] > 0\n"
        "    assert st['kv_spill']['demoted_to_disk'] > 0\n"
        "    assert aot.WarmupManifest.load(spill_dir + '/m.json').entries()\n"
        "assert 'llm_kv_reattach_total' in telemetry.prometheus_text()\n"
        "seqs, scores = beam_search(net, np.array([[1, 2, 3]]), 3,"
        " beam_size=2, weight_dtype='int8', device='cpu')\n"
        "assert seqs.shape == (1, 2, 3) and torch.isfinite(scores).all()\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'mxnet_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    t0 = time.time()
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok"), (res.stdout, time.time() - t0)
