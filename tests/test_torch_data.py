"""Parity of the port's data front door with the JAX package's, on the
CPU: ``resilience.retry``, ``gluon.data`` (samplers, batchify, datasets,
the DataLoader with 0 workers, 2 fork workers and 2 threads), the vision
transforms and synthetic datasets, ``recordio`` (files written by one
package and read by the other, byte for byte), the ``io`` iterators,
``mx.image`` and ``gluon.utils``.

Every comparison here is exact (``assert_array_equal`` on the same
seeded numpy inputs, one ``numpy.random.seed`` before each side of a
random draw), but for two: ``HybridCompose``'s torch forms against the
host transforms (float32 ops in another order, 1e-6) and
``clip_global_norm`` (a float32 sum in another order, 1e-6 relative).
The port runs under ``with tmx.cpu():``, the reference on its CPU
backend.
"""
import importlib
import pickle
import struct

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import image as jimage
from mxnet_tpu import io as jio
from mxnet_tpu import recordio as jrec
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon import utils as jutils
from mxnet_tpu.gluon.data.vision import datasets as jds
from mxnet_tpu.gluon.data.vision import transforms as jtf

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import image as timage
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon import utils as tutils
from mxnet_tpu_torch.gluon.data.vision import datasets as tds
from mxnet_tpu_torch.gluon.data.vision import transforms as ttf
from mxnet_tpu_torch.resilience import chaos
from mxnet_tpu_torch import resilience as tres

jretry = importlib.import_module("mxnet_tpu.resilience.retry")
tretry = importlib.import_module("mxnet_tpu_torch.resilience.retry")

CPU = "cpu"


def host(x):
    """numpy of a reference ndarray, a port tensor, or anything else."""
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        if x.layout == torch.sparse_csr:
            x = x.to_dense()
        return x.detach().cpu().numpy()
    if hasattr(x, "todense"):
        return host(x.todense())
    return onp.asarray(x)


def same(a, b):
    """Equal nested structures of arrays and scalars, exactly."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            same(x, y)
        return
    ha, hb = host(a), host(b)
    assert ha.shape == hb.shape, (ha.shape, hb.shape)
    onp.testing.assert_array_equal(ha, hb)


# -- resilience.retry -----------------------------------------------------
def test_retry_schedule_and_loop():
    for seed in (0, 7):
        a = jretry.RetryPolicy(seed=seed).delays()
        b = tretry.RetryPolicy(seed=seed).delays()
        assert [next(a) for _ in range(6)] == [next(b) for _ in range(6)]
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("flaky read")
        return "ok"

    pol = tretry.RetryPolicy(max_attempts=3, sleep=lambda s: None)
    assert tretry.call_with_retry(flaky, policy=pol) == "ok"
    with pytest.raises(tretry.RetriesExhausted) as e:
        tretry.call_with_retry(lambda: (_ for _ in ()).throw(OSError("x")),
                               policy=pol)
    assert e.value.attempts == 3
    again = pickle.loads(pickle.dumps(e.value))
    assert again.attempts == 3 and str(again) == str(e.value)
    with pytest.raises(ValueError):                 # fatal: no retry
        tretry.call_with_retry(lambda: int("x"), policy=pol)
    deco = tres.retry(max_attempts=2, sleep=lambda s: None)
    assert deco(lambda: 5)() == 5 and tres.RetryPolicy is tretry.RetryPolicy


# -- samplers ------------------------------------------------------------
@pytest.mark.parametrize("make", [
    lambda d: d.SequentialSampler(7, start=2),
    lambda d: d.RandomSampler(11),
    lambda d: d.IntervalSampler(10, 3),
    lambda d: d.IntervalSampler(10, 3, rollover=False),
    lambda d: d.FilterSampler(lambda s: s % 3 == 0, list(range(20))),
    lambda d: d.BatchSampler(d.RandomSampler(10), 3, "keep"),
    lambda d: d.BatchSampler(d.SequentialSampler(10), 3, "discard"),
    lambda d: d.BatchSampler(d.SequentialSampler(10), 3, "rollover"),
])
def test_sampler_orders(make):
    out = []
    for d in (jdata, tdata):
        onp.random.seed(3)
        s = make(d)
        out.append((len(s), [list(iter(s)) for _ in range(2)]))
    assert out[0] == out[1]


# -- batchify ------------------------------------------------------------
_RAGGED = [onp.arange(n * 2, dtype=onp.float32).reshape(n, 2) for n in (3, 1, 4)]


@pytest.mark.parametrize("name,args,data", [
    ("Stack", (), [onp.ones((2, 3)) * i for i in range(4)]),
    ("Pad", (), _RAGGED),
    ("Pad", (0, -1.0, "float16", 4), _RAGGED),
    ("Append", (), _RAGGED),
    ("Append", (False,), _RAGGED),
    ("AsList", (), [1, "a", 3.0]),
])
def test_batchify(name, args, data):
    from mxnet_tpu.gluon.data import batchify as jb
    from mxnet_tpu_torch.gluon.data import batchify as tb

    same(getattr(tb, name)(*args)(data), getattr(jb, name)(*args)(data))


def test_group_and_default_batchify():
    from mxnet_tpu.gluon.data import batchify as jb
    from mxnet_tpu_torch.gluon.data import batchify as tb

    samples = [(onp.full((2,), i, onp.float32), i, _RAGGED[i % 3])
               for i in range(5)]
    same(tb.Group(tb.Stack(), tb.Stack(), tb.Pad())(samples),
         jb.Group(jb.Stack(), jb.Stack(), jb.Pad())(samples))
    pairs = [s[:2] for s in samples]
    same(tb.default_batchify_fn(pairs), jb.default_batchify_fn(pairs))
    with pytest.raises(MXNetError):
        tb.Group(tb.Stack())(samples)


# -- datasets ------------------------------------------------------------
def _arrays():
    rng = onp.random.default_rng(1)
    return (rng.random((13, 2, 3), dtype=onp.float32),
            rng.integers(0, 5, 13).astype(onp.int32))


@pytest.mark.parametrize("op", [
    "getitem", "filter", "shard", "take", "sample", "transform",
    "transform_eager", "transform_first", "simple", "single"])
def test_dataset_ops(op):
    out = []
    for d in (jdata, tdata):
        x, y = _arrays()
        ds = d.ArrayDataset(x, y)
        if op == "getitem":
            r = [ds[i] for i in range(len(ds))]
        elif op == "filter":
            r = list(ds.filter(lambda s: s[1] > 2))
        elif op == "shard":
            r = [list(ds.shard(3, i)) for i in range(3)]
        elif op == "take":
            r = list(ds.take(4)) + list(ds.take(99))
        elif op == "sample":
            r = list(ds.sample(d.IntervalSampler(13, 4)))
        elif op == "transform":
            r = list(ds.transform(lambda a, b: (a * 2, b + 1)))
        elif op == "transform_eager":
            r = list(ds.transform(lambda a, b: (a - 1, b), lazy=False))
        elif op == "transform_first":
            r = list(ds.transform_first(lambda a: a.sum(0)))
        elif op == "simple":
            r = list(d.SimpleDataset(list(range(6))).transform(lambda v: v * 3))
        else:
            r = list(d.ArrayDataset(x).transform_first(lambda a: a + 1))
        out.append((len(ds), r))
    assert out[0][0] == out[1][0]
    same(out[0][1], out[1][1])
    with pytest.raises(MXNetError):
        tdata.ArrayDataset(onp.ones(3), onp.ones(4))


def test_array_dataset_keeps_host_copies():
    t = torch.arange(6.0).reshape(3, 2)
    ds = tdata.ArrayDataset(t, torch.tensor([0, 1, 2]))
    assert isinstance(ds[0][0], onp.ndarray)
    same(ds[2], (onp.array([4.0, 5.0], onp.float32), 2))


# -- DataLoader ------------------------------------------------------------
def _loader_ds(d):
    x, y = _arrays()
    return d.ArrayDataset(x.astype(onp.float64), y)


@pytest.mark.parametrize("mode", ["serial", "fork2", "thread2", "prefetch"])
@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_dataloader_batches(mode, last_batch):
    """Shuffled epochs under one numpy seed: the port's batches (0
    workers, 2 forked workers, 2 threads, a prefetch thread) equal the
    reference's 0-worker loader's, float64 uploaded as float32."""
    onp.random.seed(5)
    jl = jdata.DataLoader(_loader_ds(jdata), batch_size=4, shuffle=True,
                          last_batch=last_batch)
    want = [[b for b in jl] for _ in range(2)]
    kw = {"serial": {}, "fork2": {"num_workers": 2},
          "thread2": {"num_workers": 2, "thread_pool": True},
          "prefetch": {"prefetch": 2}}[mode]
    onp.random.seed(5)
    with tdata.DataLoader(_loader_ds(tdata), batch_size=4, shuffle=True,
                          last_batch=last_batch, pin_memory=True,
                          **kw) as tl:
        with tmx.cpu():
            got = [[b for b in tl] for _ in range(2)]
        assert len(tl) == len(jl)
    same(got, want)
    assert got[0][0][0].dtype == torch.float32
    assert got[0][0][0].device.type == "cpu"


def test_dataloader_options():
    ds = _loader_ds(tdata)
    with pytest.raises(MXNetError, match="batch_size"):
        tdata.DataLoader(ds)
    with pytest.raises(MXNetError, match="mutually exclusive"):
        tdata.DataLoader(ds, batch_size=2, batch_sampler=[[0, 1]])
    bs = tdata.BatchSampler(tdata.SequentialSampler(5), 2)
    with tmx.cpu():
        got = list(tdata.DataLoader(ds, batch_sampler=bs))
    assert [b[1].tolist() for b in got] == [
        [int(ds[i][1]) for i in idx] for idx in ([0, 1], [2, 3], [4])]
    with pytest.raises(MXNetError, match="CUDA is not available"):
        next(iter(tdata.DataLoader(ds, batch_size=2)))     # no card here


@pytest.mark.parametrize("how", ["use_service", "MXNET_TPU_IO_SERVICE",
                                 "MXNET_TPU_IO_SERVICE_NET"])
def test_dataloader_service_raises(how, monkeypatch):
    ds = _loader_ds(tdata)
    if how == "use_service":
        with pytest.raises(MXNetError, match="9b"):
            tdata.DataLoader(ds, batch_size=2, use_service=True)
        return
    monkeypatch.setenv(how, "/tmp/svc" if how.endswith("SERVICE") else "1")
    with pytest.raises(MXNetError, match="9b"):
        tdata.DataLoader(ds, batch_size=2)
    loader = tdata.DataLoader(ds, batch_size=2, use_service=False)
    with tmx.cpu():
        assert len(list(loader)) == 7


@pytest.mark.parametrize("var", ["MXNET_TPU_IO_SERVICE",
                                 "MXNET_TPU_IO_SERVICE_NET"])
@pytest.mark.parametrize("value", ["0", "no", "off", " ", "on"])
def test_dataloader_service_variables_read_as_the_reference(var, value,
                                                            monkeypatch):
    """The loader raises exactly where the reference's readers arm its
    service: any service root, and the network variable but for its own
    false words."""
    from mxnet_tpu.io import service as jsvc

    monkeypatch.setenv(var, value)
    armed = (jsvc.service_root_from_env() is not None
             if var == "MXNET_TPU_IO_SERVICE"
             else jsvc.service_net_from_env()[0])
    if armed:
        with pytest.raises(MXNetError, match="9b"):
            tdata.DataLoader(_loader_ds(tdata), batch_size=2)
    else:
        tdata.DataLoader(_loader_ds(tdata), batch_size=2)


def test_dataloader_refuses_cuda_samples_for_fork():
    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    ds = tdata.SimpleDataset([torch.zeros(2).as_subclass(OnCard)] * 4)
    with pytest.raises(MXNetError, match="fork"):
        tdata.DataLoader(ds, batch_size=2, num_workers=2)
    with tdata.DataLoader(ds, batch_size=2, num_workers=2,
                          thread_pool=True):
        pass


def test_dataloader_retries_transient_faults():
    ds = _loader_ds(tdata)
    with tmx.cpu(), chaos.scope("dataloader.next", fail="oserror", times=2):
        got = list(tdata.DataLoader(ds, batch_size=5))
    same(got[0][1], onp.array([ds[i][1] for i in range(5)]))
    with tmx.cpu(), chaos.scope("dataloader.next", fail="oserror"):
        with pytest.raises(MXNetError, match="after 3 attempts"):
            list(tdata.DataLoader(ds, batch_size=5))
    with tmx.cpu(), chaos.scope("dataloader.next", fail="fatal", times=1):
        with pytest.raises(MXNetError):
            list(tdata.DataLoader(ds, batch_size=5))


# -- vision transforms ---------------------------------------------------
_IMG = onp.random.default_rng(2).integers(0, 256, (12, 10, 3)).astype(onp.uint8)


def _transform_cases(m):
    return {
        "Compose": m.Compose([m.Resize(8), m.ToTensor()]),
        "Cast": m.Cast("float16"),
        "ToTensor": m.ToTensor(),
        "Normalize": m.Compose([m.ToTensor(), m.Normalize((0.5, 0.4, 0.3),
                                                          (0.2, 0.3, 0.4))]),
        "Resize": m.Resize((7, 5)),
        "CenterCrop": m.CenterCrop(6),
        "RandomResizedCrop": m.RandomResizedCrop(5),
        "RandomCrop": m.RandomCrop(8, pad=2),
        "RandomFlipLeftRight": m.RandomFlipLeftRight(),
        "RandomFlipTopBottom": m.RandomFlipTopBottom(),
        "RandomBrightness": m.RandomBrightness(0.4),
        "RandomContrast": m.RandomContrast(0.4),
        "RandomSaturation": m.RandomSaturation(0.4),
        "RandomLighting": m.RandomLighting(0.1),
        "RandomColorJitter": m.RandomColorJitter(0.3, 0.3, 0.3),
        "Pad": m.Pad((1, 2, 3, 4), fill=7),
        "RandomApply": m.RandomApply(m.RandomBrightness(0.5), p=0.6),
        "HybridRandomApply": m.HybridRandomApply(m.RandomContrast(0.5)),
        "RandomGray": m.RandomGray(0.7),
        "RandomHue": m.RandomHue(0.2),
        "Rotate": m.Rotate(30, zoom_in=True),
        "RandomRotation": m.RandomRotation((-40, 40), zoom_out=True),
        "CropResize": m.CropResize(1, 2, 6, 5, size=4),
    }


@pytest.mark.parametrize("name", sorted(set(ttf.__all__) - {"HybridCompose"}))
def test_transform_matches_reference(name):
    assert set(ttf.__all__) == set(jtf.__all__)
    outs = []
    for m in (jtf, ttf):
        onp.random.seed(11)
        t = _transform_cases(m)[name]
        outs.append([t(_IMG) for _ in range(4)])
    same(outs[1], outs[0])
    onp.random.seed(11)
    from_tensor = _transform_cases(ttf)[name](torch.from_numpy(_IMG))
    same(from_tensor, outs[1][0])


def test_hybrid_compose():
    """The torch forms against the host transforms and the reference's
    HybridCompose (1e-6); the random transforms refused when
    hybridized."""
    batch = onp.stack([_IMG, _IMG[::-1]])
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.3, 0.4)
    ref = jtf.HybridCompose([jtf.ToTensor(), jtf.Normalize(mean, std)])
    want = ref(jmx.np.array(batch)).asnumpy()
    hc = ttf.HybridCompose([ttf.ToTensor(), ttf.Normalize(mean, std),
                            ttf.Cast("float32")])
    hc.hybridize()
    got = hc(torch.from_numpy(batch))
    onp.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    host_one = ttf.Normalize(mean, std)(ttf.ToTensor()(_IMG))
    onp.testing.assert_allclose(got[0].numpy(), host_one, rtol=1e-6,
                                atol=1e-6)
    with tmx.cpu():
        eager = ttf.HybridCompose([ttf.ToTensor()])(_IMG)
    assert eager.shape == (3, 12, 10) and eager.dtype == torch.float32
    rnd = ttf.HybridCompose([ttf.RandomFlipLeftRight(), ttf.ToTensor()])
    with pytest.raises(MXNetError, match="RandomFlipLeftRight"):
        rnd.hybridize()
    with pytest.raises(MXNetError, match="ToTensor"):
        ttf.Normalize()(_IMG.astype(onp.float32))


# -- synthetic datasets --------------------------------------------------
@pytest.mark.parametrize("cls,kw", [
    ("MNIST", {"train": True}), ("MNIST", {"train": False}),
    ("FashionMNIST", {"train": True}), ("CIFAR10", {"train": True}),
    ("CIFAR10", {"train": False}), ("CIFAR100", {"train": True}),
    ("CIFAR100", {"train": False, "fine_label": False})])
def test_synthetic_datasets(cls, kw, tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_HOME", str(tmp_path))
    j = getattr(jds, cls)(**kw)
    t = getattr(tds, cls)(**kw)
    assert len(j) == len(t)
    onp.testing.assert_array_equal(t._data, j._data)
    onp.testing.assert_array_equal(t._label, j._label)
    same(t.transform_first(ttf.ToTensor())[5],
         j.transform_first(jtf.ToTensor())[5])
    monkeypatch.setenv("MXNET_SYNTHETIC_DATA", "0")
    with pytest.raises(MXNetError, match="not found"):
        getattr(tds, cls)(**kw)


def test_cifar10_from_files(tmp_path):
    """The on-disk pickled batches, read the same way."""
    root = tmp_path / "cifar10" / "cifar-10-batches-py"
    root.mkdir(parents=True)
    rng = onp.random.default_rng(4)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(root / name, "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (3, 3072)).astype(
                onp.uint8), "labels": [1, 2, 3]}, f)
    for train in (True, False):
        j = jds.CIFAR10(root=str(tmp_path), train=train)
        t = tds.CIFAR10(root=str(tmp_path), train=train)
        onp.testing.assert_array_equal(t._data, j._data)
        onp.testing.assert_array_equal(t._label, j._label)


# -- recordio ------------------------------------------------------------
def _records():
    magic = struct.pack("<I", 0xCED7230A)
    rng = onp.random.default_rng(6)
    return [b"", b"abc", magic, b"xy" + magic + b"zz", magic * 3 + b"q",
            b"1234" + magic + b"5678" + magic,
            rng.integers(0, 256, 1001).astype(onp.uint8).tobytes()]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_recordio_cross_read(writer, tmp_path):
    recs = _records()
    files = {}
    for name, mod in (("jax", jrec), ("torch", trec)):
        rec, idx = tmp_path / f"{name}.rec", tmp_path / f"{name}.idx"
        w = mod.MXIndexedRecordIO(str(idx), str(rec), "w")
        for i, r in enumerate(recs):
            w.write_idx(i * 3, r)
        w.close()
        files[name] = (rec.read_bytes(), idx.read_bytes())
    assert files["jax"] == files["torch"]            # byte-identical
    reader = (trec if writer == "jax" else jrec)
    rec, idx = tmp_path / f"{writer}.rec", tmp_path / f"{writer}.idx"
    r = reader.MXIndexedRecordIO(str(idx), str(rec), "r")
    assert [r.read_idx(k) for k in reversed(r.keys)] == recs[::-1]
    r.close()
    seq = reader.MXRecordIO(str(rec), "r")
    assert [seq.read() for _ in recs] == recs and seq.read() is None
    with trec.ThreadedRecordReader(str(rec), capacity=2) as tr:
        assert list(tr) == recs


@pytest.mark.parametrize("fmt", [".npy", ".png", ".jpg"])
def test_pack_img(fmt):
    img = _IMG if fmt != ".npy" else _IMG.astype(onp.float32)
    for label in (3.0, [1.0, 2.5, -1.0]):
        h = (jrec.IRHeader(0, label, 7, 9), trec.IRHeader(0, label, 7, 9))
        pj = jrec.pack_img(h[0], img, quality=90, img_fmt=fmt)
        pt = trec.pack_img(h[1], img, quality=90, img_fmt=fmt)
        assert pj == pt
        for iscolor in (-1, 0, 1):
            hj, ij = jrec.unpack_img(pj, iscolor)
            ht, it = trec.unpack_img(pt, iscolor)
            same(it, ij)
            assert (ht.flag, ht.id, ht.id2) == (hj.flag, hj.id, hj.id2)
            same(ht.label, hj.label)
    with pytest.raises(MXNetError):
        trec.pack_img(trec.IRHeader(0, 1.0, 0, 0), _IMG, img_fmt=".bmpx")


# -- io iterators --------------------------------------------------------
def _batches(it, epochs=2):
    out = []
    for _ in range(epochs):
        out.append([(b.data, b.label, b.pad) for b in it])
        it.reset()
    return out


def _same_batches(got, want):
    for eg, ew in zip(got, want):
        assert len(eg) == len(ew)
        for (dg, lg, pg), (dw, lw, pw) in zip(eg, ew):
            same(dg, dw)
            same(lg, lw)
            assert pg == pw


@pytest.mark.parametrize("lbh", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter(lbh, shuffle):
    x, y = _arrays()
    its = []
    for mod in (jio, tio):
        onp.random.seed(9)
        with tmx.cpu():
            it = mod.NDArrayIter({"a": x, "b": x[:, 0]}, y, batch_size=5,
                                 shuffle=shuffle, last_batch_handle=lbh)
        its.append((_batches(it, 3), it.provide_data, it.provide_label))
    _same_batches(its[1][0], its[0][0])
    assert its[1][1:] == its[0][1:]


def test_csv_and_libsvm_iters(tmp_path):
    x, y = _arrays()
    data_csv, label_csv = tmp_path / "d.csv", tmp_path / "l.csv"
    onp.savetxt(data_csv, x.reshape(13, -1), delimiter=",")
    onp.savetxt(label_csv, y, delimiter=",")
    svm = tmp_path / "d.svm"
    svm.write_text("1 0:1.5 3:2\n0 2:-1\n\n1 1:0.25 4:4 5:5\n0\n1 0:9\n")
    for mod in (jio, tio):
        for rb in (True, False):
            with tmx.cpu():
                it = mod.CSVIter(str(data_csv), (2, 3), str(label_csv), (1,),
                                 batch_size=4, round_batch=rb)
                sv = mod.LibSVMIter(str(svm), 6, batch_size=2, round_batch=rb)
            got = _batches(it)
            got_svm = _batches(sv)
            if mod is jio:
                want, want_svm = got, got_svm
    _same_batches(got, want)
    _same_batches(got_svm, want_svm)
    assert got_svm[0][0][0][0].layout == torch.sparse_csr
    with tmx.cpu(), pytest.raises(MXNetError, match="feature index"):
        tio.LibSVMIter(str(svm), 3)


def test_resize_and_prefetching_iters():
    x, y = _arrays()
    outs = []
    for mod in (jio, tio):
        with tmx.cpu():
            base = mod.NDArrayIter(x, y, batch_size=4,
                                   last_batch_handle="discard")
            rs = mod.ResizeIter(base, 5)
            pf = mod.PrefetchingIter(mod.NDArrayIter(x, y, batch_size=3),
                                     capacity=2)
        outs.append((_batches(rs), _batches(pf)))
    _same_batches(outs[1][0], outs[0][0])
    _same_batches(outs[1][1], outs[0][1])


def _write_image_rec(mod, path, n, shape, fmt=".npy", label_width=1):
    rng = onp.random.default_rng(8)
    w = mod.MXIndexedRecordIO(str(path)[:-4] + ".idx", str(path), "w")
    for i in range(n):
        img = rng.integers(0, 256, shape).astype(onp.uint8)
        label = (float(i % 7) if label_width == 1
                 else [float(i), float(-i)])
        w.write_idx(i, mod.pack_img(mod.IRHeader(0, label, i, 0), img,
                                    img_fmt=fmt))
    w.close()


@pytest.mark.parametrize("label_width", [1, 2])
@pytest.mark.parametrize("round_batch", [True, False])
def test_image_record_iter(tmp_path, label_width, round_batch):
    rec = tmp_path / "img.rec"
    _write_image_rec(trec, rec, 11, (6, 5, 3), label_width=label_width)
    outs = []
    for mod in (jio, tio):
        with tmx.cpu():
            it = mod.ImageRecordIter(str(rec), 4, (3, 6, 5),
                                     label_width=label_width,
                                     round_batch=round_batch)
        outs.append((_batches(it), it.provide_data, it.provide_label))
        if mod is tio:
            it.close()
    _same_batches(outs[1][0], outs[0][0])
    assert outs[1][1:] == outs[0][1:]
    ds_j, ds_t = (m.ImageRecordDataset(str(rec)) for m in (jds, tds))
    assert len(ds_t) == len(ds_j) == 11
    same([ds_t[i] for i in range(11)], [ds_j[i] for i in range(11)])


@pytest.mark.parametrize("kw", [
    {"rand_crop": True}, {"rand_mirror": True}, {"use_native": True},
    {"num_workers": 2}, {"cache_dir": "/tmp/c"}, {"use_service": True}])
def test_image_record_iter_native_options_raise(tmp_path, kw):
    rec = tmp_path / "img.rec"
    _write_image_rec(trec, rec, 2, (4, 4, 3))
    with pytest.raises(MXNetError, match="9b" if "use_service" in kw
                       else "9a-2"):
        with tmx.cpu():
            tio.ImageRecordIter(str(rec), 2, (3, 4, 4), **kw)


def test_record_dataset_in_fork_workers(tmp_path):
    """RecordFileDataset opens its file per process: 2 forked workers
    read every record right."""
    rec = tmp_path / "img.rec"
    _write_image_rec(trec, rec, 9, (4, 4, 3))
    ds = tds.ImageRecordDataset(str(rec)).transform_first(ttf.ToTensor())
    with tmx.cpu(), tdata.DataLoader(ds, batch_size=3, num_workers=2) as dl:
        got = list(dl)
        want = list(tdata.DataLoader(ds, batch_size=3))
    same(got, want)


# -- folder and list datasets, mx.image ------------------------------------
@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgs")
    rng = onp.random.default_rng(10)
    from PIL import Image

    for cls in ("cat", "dog"):
        (root / cls).mkdir()
        for i in range(3):
            img = rng.integers(0, 256, (9, 11, 3)).astype(onp.uint8)
            Image.fromarray(img).save(root / cls / f"{i}.png")
            onp.save(root / cls / f"{i}.npy", img[:, :, 0])
    lines = [f"{i}\t{i % 2}\t{cls}/{i}.png" for cls in ("cat", "dog")
             for i in range(3)]
    (root / "list.lst").write_text("\n".join(lines) + "\n")
    rec = root / "imgs.rec"
    w = trec.MXRecordIO(str(rec), "w")
    for i in range(5):
        img = rng.integers(0, 256, (14, 12, 3)).astype(onp.uint8)
        w.write(trec.pack_img(trec.IRHeader(0, float(i), i, 0), img,
                              img_fmt=".png" if i % 2 else ".npy"))
    w.close()
    return root


def test_folder_and_list_datasets(image_root):
    for flag in (0, 1):
        j = jds.ImageFolderDataset(str(image_root), flag=flag)
        t = tds.ImageFolderDataset(str(image_root), flag=flag)
        assert t.synsets == j.synsets and len(t) == len(j) == 12
        same([t[i] for i in range(len(t))], [j[i] for i in range(len(j))])
    j = jds.ImageListDataset(str(image_root), "list.lst")
    t = tds.ImageListDataset(str(image_root), "list.lst")
    same([t[i] for i in range(6)], [j[i] for i in range(6)])


@pytest.mark.parametrize("fn", [
    "imread", "imdecode", "imdecode_npy", "imresize", "resize_short",
    "fixed_crop", "center_crop", "random_crop", "random_size_crop",
    "color_normalize", "imsave"])
def test_image_functions(fn, image_root, tmp_path):
    png = str(image_root / "cat" / "1.png")
    buf = open(png, "rb").read()
    outs = []
    for mod in (jimage, timage):
        onp.random.seed(12)
        with tmx.cpu():
            src = mod.imread(png)
            if fn == "imread":
                r = [mod.imread(png), mod.imread(png, flag=0)]
            elif fn == "imdecode":
                r = [mod.imdecode(buf), mod.imdecode(buf, flag=0)]
            elif fn == "imdecode_npy":
                import io as _io
                b = _io.BytesIO()
                onp.save(b, _IMG)
                r = mod.imdecode(b.getvalue())
            elif fn == "imresize":
                r = [mod.imresize(src, 7, 4, interp=i) for i in range(4)]
            elif fn == "resize_short":
                r = mod.resize_short(src, 6)
            elif fn == "fixed_crop":
                r = [mod.fixed_crop(src, 1, 2, 5, 4),
                     mod.fixed_crop(src, 1, 2, 5, 4, size=(3, 3))]
            elif fn == "center_crop":
                r = list(mod.center_crop(src, (5, 4)))
            elif fn == "random_crop":
                r = list(mod.random_crop(src, (5, 4)))
            elif fn == "random_size_crop":
                r = list(mod.random_size_crop(src, (4, 4), 0.3, (0.75, 1.33)))
            elif fn == "color_normalize":
                r = mod.color_normalize(src, onp.array([120.0, 110, 100]),
                                        onp.array([50.0, 60, 70]))
            else:
                out = str(tmp_path / f"{mod.__name__}.png")
                mod.imsave(out, src)
                r = open(out, "rb").read()
        outs.append(r)
    if fn == "imsave":
        assert outs[0] == outs[1]
    else:
        same(outs[1], outs[0])


def test_augmenters_and_image_iter(image_root):
    mean, std = onp.array([1.0, 2.0, 3.0]), onp.array([2.0, 2.0, 2.0])
    outs = []
    for mod in (jimage, timage):
        onp.random.seed(13)
        with tmx.cpu():
            src = mod.imread(str(image_root / "dog" / "0.png"))
            augs = mod.CreateAugmenter((3, 6, 6), resize=8, rand_crop=True,
                                       rand_mirror=True, mean=mean, std=std)
            r = [type(a).__name__ for a in augs]
            img = src
            for a in augs:
                img = a(img)
            r2 = [img, mod.HorizontalFlipAug(1.0)(src),
                  mod.CenterCropAug((4, 4))(src), mod.CastAug("float16")(src)]
            it = mod.ImageIter(2, (3, 8, 8), path_imgrec=str(image_root /
                                                            "imgs.rec"),
                               shuffle=True)
            it2 = mod.ImageIter(4, (3, 5, 5), path_imglist=str(
                image_root / "list.lst"), path_root=str(image_root),
                rand_crop=True)
            b = [(x.data, x.label, x.pad) for x in it]
            b2 = [(x.data, x.label, x.pad) for x in it2]
        outs.append((r, r2, b, b2))
    assert outs[0][0] == outs[1][0]
    same(outs[1][1], outs[0][1])
    for k in (2, 3):
        _same_batches([outs[1][k]], [outs[0][k]])
    with tmx.cpu(), pytest.raises(MXNetError):
        timage.ImageIter(2, (3, 8), path_imgrec="x")


def test_image_without_pil(monkeypatch):
    """Without PIL, encoded images raise naming PIL and numpy-framed
    payloads still decode."""
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(MXNetError, match="PIL"):
        timage.imdecode(b"\x89PNG\r\n\x1a\n....")
    with pytest.raises(MXNetError, match="PIL"):
        trec.pack_img(trec.IRHeader(0, 1.0, 0, 0), _IMG, img_fmt=".jpg")
    payload = trec.pack_img(trec.IRHeader(0, 1.0, 0, 0), _IMG, img_fmt=".npy")
    same(trec.unpack_img(payload)[1], _IMG)
    with tmx.cpu():
        same(timage.imdecode(trec.unpack(payload)[1]), _IMG)


# -- gluon.utils ---------------------------------------------------------
def test_gluon_utils(tmp_path):
    x = onp.arange(24, dtype=onp.float32).reshape(6, 4)
    for n, even in ((3, True), (4, False)):
        same(tutils.split_data(torch.from_numpy(x), n, 0, even),
             jutils.split_data(jmx.np.array(x), n, 0, even))
    same(tutils.split_and_load(x, [CPU, "cpu"], batch_axis=1),
         jutils.split_and_load(x, [jmx.cpu(), jmx.cpu()], batch_axis=1))
    same(tutils.split_and_load(x.astype(onp.float64), [CPU]),
         jutils.split_and_load(x, [jmx.cpu()]))
    with pytest.raises(MXNetError):
        tutils.split_data(torch.from_numpy(x), 4)
    ta = [torch.from_numpy(x.copy()), torch.ones(3) * 2]
    ja = [jmx.np.array(x), jmx.np.ones((3,)) * 2]
    nt = tutils.clip_global_norm(ta, 5.0)
    nj = jutils.clip_global_norm(ja, 5.0)
    assert abs(nt - nj) <= 1e-6 * nj
    for a, b in zip(ta, ja):
        onp.testing.assert_allclose(a.numpy(), b.asnumpy(), rtol=1e-6)
    with pytest.warns(UserWarning):
        tutils.clip_global_norm([torch.tensor([float("inf")])], 1.0)
    src = tmp_path / "f.bin"
    src.write_bytes(b"mxnet" * 100)
    import hashlib

    sha = hashlib.sha1(src.read_bytes()).hexdigest()
    assert tutils.check_sha1(str(src), sha) == jutils.check_sha1(str(src), sha)
    dst = tmp_path / "copy.bin"
    assert tutils.download("file://" + str(src), str(dst)) == str(dst)
    assert dst.read_bytes() == src.read_bytes()
    assert tutils.download("http://example.invalid/f.bin", str(dst)) == str(dst)
    with pytest.raises(MXNetError, match="network"):
        tutils.download("http://example.invalid/g.bin", str(tmp_path / "g"))
