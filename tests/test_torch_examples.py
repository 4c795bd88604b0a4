"""The port's three small examples and its graph-building CLI against the
JAX package's (examples/*.py and tools/build_graphs.py, imported by
path), at small sizes on the CPU.

* ``tools.build_graphs``: den.fst and num.ark byte for byte as the JAX
  tool writes them from the same ``text`` (flat and linear numerators,
  LM orders 2 and 3), num.scp up to its directory, the phone LM's
  arrays equal, and den.fst / num.scp read back through the port's
  readers;
* ``data_pipeline``: the same buckets and losses (1e-4: the JAX example
  prints four decimals);
* ``train_tdnn`` and ``wav_to_train``: three steps from the JAX
  example's initial weights (``convert.model_from_flax``) against a JAX
  step built as the example builds it, on the same data (the port draws
  it with the JAX example's random stream): every step's loss within
  1e-5 relative (the first from the same weights, the later ones as
  tests/test_torch_recipe.py holds the recipe), and for train_tdnn
  every parameter and BatchNorm statistic after them within 1e-5 of its
  norm;
* ``--dp`` in a group of one rank equal to the run without it (two
  ranks: tests/test_torch_parallel.py); without ``--device`` every
  example raises on a machine with no card; wav_to_train's default
  directory is its own.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pychain_tpu import ChainGraph as JChainGraph
from pychain_tpu import ChainGraphBatch as JChainGraphBatch
from pychain_tpu.data import BucketSpec as JBucketSpec
from pychain_tpu.data import LengthBucketer as JLengthBucketer
from pychain_tpu.data import pad_to_bucket as j_pad_to_bucket
from pychain_tpu.loss import chain_loss as j_chain_loss
from pychain_tpu.loss import chain_loss_xent as j_chain_loss_xent
from pychain_tpu.loss import dispatch_arrays as j_dispatch
from pychain_tpu.loss import graph_arrays as j_graph_arrays
from pychain_tpu.models import TDNN as JTDNN
from pychain_tpu.models import TDNNConfig as JTDNNConfig
from pychain_tpu.utils.testgraphs import denominator_fst as j_den_fst
from pychain_tpu.utils.testgraphs import linear_fst as j_linear_fst

from pychain_tpu_torch.convert import model_from_flax, model_to_flax
from pychain_tpu_torch.data import read_scp
from pychain_tpu_torch.examples import data_pipeline as pdp
from pychain_tpu_torch.examples import train_tdnn as ptt
from pychain_tpu_torch.examples import wav_to_train as pwt
from pychain_tpu_torch.graphs import FST, PhoneLM
from pychain_tpu_torch.tools import build_graphs as pbg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _by_path(name, rel):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jbg = _by_path("jax_build_graphs", "tools/build_graphs.py")
jdp = _by_path("jax_data_pipeline", "examples/data_pipeline.py")
jtt = _by_path("jax_train_tdnn", "examples/train_tdnn.py")
jwt = _by_path("jax_wav_to_train", "examples/wav_to_train.py")


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


# ----------------------------------------------------------------------
# tools/build_graphs.py
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def text(tmp_path_factory):
    """A data dir's ``text``: the transcripts wav_to_train draws."""
    d = str(tmp_path_factory.mktemp("wav"))
    pwt.synth_corpus(d, utts=8, num_phones=6)
    with open(os.path.join(d, "text")) as f:
        return f.read()


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("num_style", ["flat", "linear"])
def test_build_graphs_writes_the_jax_tools_bytes(tmp_path, monkeypatch,
                                                 text, order, num_style):
    flags = ["--order", str(order), "--num-style", num_style,
             "--max-lm-states", "20"]
    dirs = {}
    for side in ("jax", "port"):
        d = str(tmp_path / side)
        os.makedirs(d)
        with open(os.path.join(d, "text"), "w") as f:
            f.write(text)
        dirs[side] = d
    monkeypatch.setattr("sys.argv", ["build_graphs.py", "--data-dir",
                                     dirs["jax"]] + flags)
    jbg.main()
    pbg.main(["--data-dir", dirs["port"]] + flags)
    for name in ("den.fst", "num.ark"):
        with open(os.path.join(dirs["jax"], name), "rb") as f:
            want = f.read()
        with open(os.path.join(dirs["port"], name), "rb") as f:
            assert f.read() == want, name
    scp = {}
    for side, d in dirs.items():
        with open(os.path.join(d, "num.scp")) as f:
            scp[side] = f.read().replace(d, "DIR")
    assert scp["port"] == scp["jax"]
    with np.load(os.path.join(dirs["jax"], "phone_lm.npz")) as a, \
            np.load(os.path.join(dirs["port"], "phone_lm.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], k)
    # the files load back through the port's readers
    d = dirs["port"]
    den = FST.read(os.path.join(d, "den.fst"))
    entries = read_scp(os.path.join(d, "num.scp"))
    assert len(entries) == 8 and den.num_states > 0
    for _, path, off in entries:
        assert FST.read_ark(path, off).num_arcs > 0
    assert PhoneLM.load(os.path.join(d, "phone_lm.npz")).order == order


def test_build_graphs_refuses_a_dir_without_text(tmp_path):
    with pytest.raises(SystemExit):
        pbg.main(["--data-dir", str(tmp_path)])


# ----------------------------------------------------------------------
# examples/data_pipeline.py
# ----------------------------------------------------------------------

def test_data_pipeline_matches_jax(capsys):
    jdp.main()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("bucket")]
    got = pdp.main(["--device", "cpu"])
    assert len(got) == len(lines) == 3
    for (t_pad, idx, loss), line in zip(got, lines):
        head, val = line.rsplit("loss=", 1)
        assert head == f"bucket T={t_pad}: batch={len(idx)} "
        assert abs(loss - float(val)) <= 1e-4, (loss, val)


# ----------------------------------------------------------------------
# examples/train_tdnn.py
# ----------------------------------------------------------------------

# the example's phones and features, fewer and shorter utterances
TDNN_FLAGS = ["--steps", "3", "--batch-size", "4", "--num-phones", "24",
              "--feat-dim", "40", "--utts", "16", "--min-t", "20",
              "--max-t", "40", "--verbose", "0"]


def _jax_train_tdnn(args, steps):
    """examples/train_tdnn.py's data and loop, its steps' losses and the
    variables after them (and before)."""
    rng = np.random.RandomState(0)
    den_fst, P = j_den_fst(num_phones=args.num_phones, states_per_phone=2,
                           seed=0)
    den_graph = JChainGraph(den_fst, log_domain=False)
    data = []
    for _ in range(args.utts):
        t_len = rng.randint(args.min_t, args.max_t + 1)
        feats, pdfs = jtt.synth_utterance(rng, den_graph, P, t_len,
                                          args.feat_dim)
        data.append((feats, JChainGraph(j_linear_fst(pdfs),
                                        log_domain=True)))
    model = JTDNN(JTDNNConfig(num_pdfs=P, hidden_dim=128,
                              kernel_sizes=(3, 3, 3), dilations=(1, 1, 2),
                              strides=(1, 1, 1), dropout=0.0))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, args.max_t, args.feat_dim)),
                        train=False)
    init = params
    tx = optax.adam(args.lr)
    opt_state = tx.init(params)

    @jax.jit
    def train_step(params, opt_state, feats, lengths, num_g, den_g):
        def loss_fn(p):
            return j_chain_loss(model.apply(p, feats, train=False), lengths,
                                num_g, den_g)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return loss, optax.apply_updates(params, updates), opt_state

    lengths_all = [d[0].shape[0] for d in data]
    bucketer = JLengthBucketer(JBucketSpec.linear(step=20,
                                                  max_t=args.max_t),
                               shuffle=True)
    losses, epoch = [], 0
    while len(losses) < steps:
        epoch += 1
        for idx in bucketer.batches(lengths_all, args.batch_size,
                                    epoch=epoch):
            if len(losses) >= steps:
                break
            if len(idx) < args.batch_size:
                continue
            t_pad = bucketer.padded_shape(lengths_all, idx)
            feats, lens = j_pad_to_bucket([d[0] for d in data], idx, t_pad)
            num_g = j_graph_arrays(JChainGraphBatch(
                [data[int(i)][1] for i in idx],
                max_num_transitions=args.max_t,
                max_num_states=args.max_t + 1))
            den_g = j_dispatch(JChainGraphBatch(den_graph, len(idx)))
            loss, params, opt_state = train_step(
                params, opt_state, jnp.asarray(feats), jnp.asarray(lens),
                num_g, den_g)
            losses.append(float(loss))
    return P, losses, init, params


def test_train_tdnn_matches_jax():
    args = ptt.parse_args(TDNN_FLAGS)
    P, jlosses, init, final = _jax_train_tdnn(args, 3)
    model = model_from_flax(ptt.model_config(P),
                            jax.tree.map(np.asarray, init), device="cpu")
    res = ptt.main(TDNN_FLAGS + ["--device", "cpu"], model=model)
    assert res["steps"] == 3 and res["ok"]
    np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-5)
    got = dict(_flat(model_to_flax(res["model"])))
    before = dict(_flat(init))
    for path, want in _flat(final):
        assert not np.array_equal(want, before[path]), path   # it moved
        err = np.linalg.norm(got[path] - want)
        assert err <= 1e-5 * np.linalg.norm(want), (path, err)


def test_train_tdnn_checkpoint_resume(tmp_path):
    """A run to 3 steps with --ckpt; a rerun to 3 restores it and takes
    no step (the model and Adam state are the saved ones); a resume to 5
    takes 2."""
    ckpt = str(tmp_path / "ckpt")
    flags = TDNN_FLAGS[2:] + ["--device", "cpu", "--ckpt", ckpt]
    first = ptt.main(["--steps", "3"] + flags)
    same = ptt.main(["--steps", "3"] + flags)
    assert first["steps"] == 3 and same["steps"] == 0
    want = first["model"].state_dict()
    for k, v in same["model"].state_dict().items():
        assert torch.equal(v, want[k]), k
    again = ptt.main(["--steps", "5"] + flags)
    assert again["steps"] == 2 and len(again["losses"]) == 2
    assert all(np.isfinite(again["losses"]))


# ----------------------------------------------------------------------
# examples/wav_to_train.py
# ----------------------------------------------------------------------

def _jax_wav(data_dir, utts, steps):
    """examples/wav_to_train.py's pipeline and steps on ``utts``
    utterances (its own synth_corpus): losses, mmi, xent and the initial
    variables."""
    transcripts = jwt.synth_corpus(data_dir, utts=utts, num_phones=8)
    B = len(transcripts)
    cfg = jwt.FbankConfig(sample_rate=jwt.SR, num_bins=40)
    wavs = [jwt.read_wav(os.path.join(data_dir, f"utt{i:03d}.wav"))[0]
            for i in range(B)]
    padded = np.zeros((B, max(len(w) for w in wavs)), np.float32)
    for i, w in enumerate(wavs):
        padded[i, :len(w)] = w
    feats = jax.jit(lambda s: jwt.fbank_batch(s, cfg))(padded)
    lens_j = jnp.asarray([jwt.num_frames(len(w), cfg) for w in wavs],
                         jnp.int32)
    topo = jwt.ChainTopology(num_phones=8)
    lm = jwt.estimate_phone_lm(transcripts, num_phones=8, order=2)
    den = JChainGraph(jwt.make_denominator_fst(lm, topo), log_domain=False)
    nums = [JChainGraph(jwt.make_numerator_fst(t, topo), log_domain=True)
            for t in transcripts]
    num_batch = JChainGraphBatch(
        nums, max_num_transitions=max(g.num_transitions for g in nums),
        max_num_states=max(g.num_states for g in nums))
    den_batch = JChainGraphBatch(den, B)
    model = JTDNN(JTDNNConfig(num_pdfs=topo.num_pdfs, hidden_dim=128,
                              kernel_sizes=(3, 3, 3), dilations=(1, 1, 2),
                              strides=(1, 1, 1), dropout=0.0))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, feats.shape[1], 40)), train=False)
    init = params
    tx = optax.adam(2e-3)
    opt_state = tx.init(params)

    @jax.jit
    def step_fn(params, opt_state):
        def loss_fn(p):
            out = model.apply(p, feats, train=False)
            return j_chain_loss_xent(out, out, lens_j, num_batch, den_batch,
                                     xent_regularize=0.1,
                                     l2_regularize=5e-4)
        (loss, parts), grads = jax.value_and_grad(loss_fn,
                                                  has_aux=True)(params)
        updates, new_opt = tx.update(grads, opt_state)
        return loss, parts, optax.apply_updates(params, updates), new_opt

    losses, mmis, xents = [], [], []
    for _ in range(steps):
        loss, (mmi, xent), params, opt_state = step_fn(params, opt_state)
        losses.append(float(loss))
        mmis.append(float(mmi))
        xents.append(float(xent))
    return topo.num_pdfs, losses, mmis, xents, init


def test_wav_to_train_matches_jax(tmp_path):
    P, jlosses, jmmi, jxent, init = _jax_wav(str(tmp_path / "jax"), 6, 3)
    model = model_from_flax(pwt.model_config(P),
                            jax.tree.map(np.asarray, init), device="cpu")
    res = pwt.main(["--data-dir", str(tmp_path / "port"), "--steps", "3",
                    "--utts", "6", "--device", "cpu"], model=model)
    for f in ("text",) + tuple(f"utt{i:03d}.wav" for i in range(6)):
        with open(tmp_path / "jax" / f, "rb") as a, \
                open(tmp_path / "port" / f, "rb") as b:
            assert a.read() == b.read(), f
    assert res["den_engine"] == "xla"
    np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-5)
    np.testing.assert_allclose(res["mmi"], jmmi, rtol=1e-5)
    np.testing.assert_allclose(res["xent"], jxent, rtol=1e-5)
    assert res["losses"][-1] < res["losses"][0]


def test_wav_default_dir_is_the_ports_own():
    assert pwt.default_data_dir() != "/tmp/pychain_tpu_wav"
    assert "pychain_tpu_torch" in pwt.default_data_dir()


# ----------------------------------------------------------------------
# Refusals
# ----------------------------------------------------------------------

def test_dp_raises_naming_parallelism():
    """--dp runs: on the CPU with no launcher, a group of one rank,
    whose steps are the single-process run's bit for bit."""
    try:
        dp = ptt.main(TDNN_FLAGS + ["--dp", "--device", "cpu"])
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    one = ptt.main(TDNN_FLAGS + ["--device", "cpu"])
    assert dp["dp"] == 1 and dp["steps"] == 3 and dp["ok"]
    assert dp["losses"] == one["losses"]


@pytest.mark.parametrize("name", ["data_pipeline", "train_tdnn",
                                  "wav_to_train"])
def test_default_device_needs_a_card(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    argv = {"data_pipeline": [], "train_tdnn": TDNN_FLAGS,
            "wav_to_train": ["--data-dir", str(tmp_path), "--steps", "1",
                             "--utts", "2"]}[name]
    mod = {"data_pipeline": pdp, "train_tdnn": ptt,
           "wav_to_train": pwt}[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)
