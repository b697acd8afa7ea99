"""Decoder pretraining and the reference's checkpoints in the port
against the JAX package's models/pretrain.py and tools/pretrain_decoders.py.

- load_pretrained_decoders of both packages on the same reference-format
  coarse.pt / middle_fine.pt, built here from seeded arrays (the files
  are not in the repository): equal (exact), and the engine reads them
  when the repository's npz is absent;
- one pretraining step on the batch JAX draws (passed in): the loss
  (rtol 1e-5) and the updated decoders (where the Adam step is set, so
  that |step| > 0.9 lr: atol 1e-6; the colour and coarse decoders
  unchanged in both);
- the port's pretraining tool writes the JAX tool's npz keys and shapes,
  and both packages' load_npz_decoders read the file alike (exact).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nice_slam_tpu.models import pretrain as jpre  # noqa: E402
from nice_slam_tpu.models.decoders import init_model as jax_init_model  # noqa: E402
from nice_slam_tpu.models.decoders import model_apply as jax_model_apply  # noqa: E402
from nice_slam_tpu.models.decoders import nice_model_spec  # noqa: E402
from nice_slam_tpu.state import init_grids as jax_init_grids  # noqa: E402
from test_slam import TEST_CFG  # noqa: E402

from nice_slam_torch.config import load_config  # noqa: E402
from nice_slam_torch.convert import params_from_jax  # noqa: E402
from nice_slam_torch.engine import SlamEngine  # noqa: E402
from nice_slam_torch.models import pretrain  # noqa: E402
from nice_slam_torch.models.decoders import ModelSpec, init_model  # noqa: E402
from nice_slam_torch.ops.optim import adam_init  # noqa: E402
from nice_slam_torch.tools import pretrain_decoders as tool  # noqa: E402
from nice_slam_torch.utils.checkpoint import _flatten  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flat(tree):
    out = {}
    _flatten(tree, "params", out)
    return {k: np.asarray(v) for k, v in out.items()}


def _state_dict(params: dict, prefix: str, rng) -> dict:
    """A reference decoder state_dict (nn.Linear weights are (out, in))
    of the shapes of one port decoder, with seeded values."""
    sd = {}

    def put(key, shape):
        sd[prefix + key] = torch.from_numpy(
            rng.randn(*shape).astype(np.float32))

    for i, layer in enumerate(params["pts"]):
        put(f"pts_linears.{i}.weight", tuple(layer["w"].shape)[::-1])
        put(f"pts_linears.{i}.bias", tuple(layer["b"].shape))
    for i, layer in enumerate(params.get("fc_c", [])):
        put(f"fc_c.{i}.weight", tuple(layer["w"].shape)[::-1])
        put(f"fc_c.{i}.bias", tuple(layer["b"].shape))
    put("output_linear.weight", tuple(params["out"]["w"].shape)[::-1])
    put("output_linear.bias", tuple(params["out"]["b"].shape))
    if "B" in params.get("embed", {}):
        put("embedder._B", tuple(params["embed"]["B"].shape))
    return sd


@pytest.fixture(scope="module")
def pt_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pt")
    rng = np.random.RandomState(0)
    tmpl = init_model(torch.Generator().manual_seed(0), ModelSpec(),
                      device="cpu")
    coarse = _state_dict(tmpl["coarse"], "decoder.", rng)
    coarse["encoder.conv.weight"] = torch.zeros(2)
    mf = {**_state_dict(tmpl["middle"], "decoder.coarse.", rng),
          **_state_dict(tmpl["fine"], "decoder.fine.", rng)}
    mf["encoder.decoder_like.weight"] = torch.zeros(2)  # skipped
    paths = (str(d / "coarse.pt"), str(d / "middle_fine.pt"))
    torch.save({"model": coarse}, paths[0])
    torch.save({"model": mf}, paths[1])
    return paths


def test_load_pretrained_decoders_matches_jax(pt_files):
    params_j = jax_init_model(jax.random.PRNGKey(0), nice_model_spec())
    want = flat(jax.tree.map(np.asarray, jpre.load_pretrained_decoders(
        params_j, nice_model_spec(), *pt_files)))
    tmpl = init_model(torch.Generator().manual_seed(1), ModelSpec(),
                      device="cpu")
    got = pretrain.load_pretrained_decoders(tmpl, ModelSpec(), *pt_files)
    got_f = flat(got)
    assert sorted(got_f) == sorted(want)
    tmpl_f = flat(tmpl)
    for k in want:
        if k.startswith("params/color/"):
            # not in the reference's files: each package keeps its init
            np.testing.assert_array_equal(got_f[k], tmpl_f[k], err_msg=k)
        else:
            np.testing.assert_array_equal(got_f[k], want[k], err_msg=k)
    assert got["fine"]["pts"][0]["w"].is_contiguous()


def test_engine_reads_pt_when_npz_absent(pt_files, tmp_path):
    cfg = load_config(overrides={
        **TEST_CFG, "synthetic": {"n_frames": 2},
        "pretrained_decoders": {"tpu_npz": str(tmp_path / "none.npz"),
                                "coarse": pt_files[0],
                                "middle_fine": pt_files[1]}})
    eng = SlamEngine(cfg, output=str(tmp_path), device="cpu")
    want = flat(pretrain.load_pretrained_decoders(
        init_model(torch.Generator().manual_seed(0), ModelSpec(),
                   device="cpu"), ModelSpec(), *pt_files))
    got = flat(eng.map_state.params)
    for k in want:
        if not k.startswith("params/color/"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pretrain_step_matches_jax():
    bound = np.array([[-1.0, 1.5], [-1.0, 1.0], [-1.2, 1.0]], np.float32)
    lr, batch = 1e-3, 512
    key = jax.random.PRNGKey(5)
    params_j = jax_init_model(jax.random.PRNGKey(1), nice_model_spec())
    grids_j = jax_init_grids(jax.random.PRNGKey(2), bound,
                             pretrain.PRETRAIN_GRID_LEN, 32, True, 2)
    out_j = jpre.pretrain_decoders_synthetic(
        key, params_j, nice_model_spec(), bound, steps=1, batch=batch,
        lr=lr, grids=grids_j)
    # the batch JAX's step draws (models/pretrain.py:167-170)
    _, k = jax.random.split(key)
    k1, k2, k3 = jax.random.split(k, 3)
    lo, hi = jnp.asarray(bound[:, 0]), jnp.asarray(bound[:, 1])
    centers = lo + (hi - lo) * jax.random.uniform(k1, (6, 3))
    radii = 0.1 + 0.4 * jax.random.uniform(k2, (6,))
    p = lo + (hi - lo) * jax.random.uniform(k3, (batch, 3))
    raw_j = jax_model_apply(params_j, nice_model_spec(), grids_j,
                            jnp.asarray(bound), p, "fine")
    d = jnp.linalg.norm(p[:, None] - centers[None], axis=-1) - radii
    loss_j = float(jnp.mean((jnp.tanh(raw_j[:, 3])
                             - jnp.tanh(-10.0 * jnp.min(d, axis=-1))) ** 2))

    tree = {"params": params_from_jax(jax.tree.map(np.asarray, params_j),
                                      device="cpu"),
            "grids": params_from_jax({k_: np.asarray(v)
                                      for k_, v in grids_j.items()},
                                     device="cpu")}
    before = flat(tree["params"])
    tree, _, loss = pretrain.pretrain_step(
        tree, adam_init(tree), pretrain.pretrain_frozen(tree), ModelSpec(),
        torch.from_numpy(bound), torch.from_numpy(np.array(p)),
        torch.from_numpy(np.array(centers)),
        torch.from_numpy(np.array(radii)), lr)
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    want = flat(jax.tree.map(np.asarray, out_j))
    got = flat(tree["params"])
    n_set = n_all = 0
    for k_ in want:
        dj, dt = want[k_] - before[k_], got[k_] - before[k_]
        if k_.startswith(("params/color/", "params/coarse/")):
            assert not dj.any() and not dt.any(), k_
            continue
        set_ = np.abs(dj) > 0.9 * lr
        np.testing.assert_allclose(dt[set_], dj[set_], atol=1e-6,
                                   err_msg=k_)
        assert (np.abs(dt) <= lr + 1e-6).all(), k_
        n_set, n_all = n_set + set_.sum(), n_all + set_.size
    assert n_set > 0.5 * n_all, (n_set, n_all)


def test_pretrain_decoders_synthetic_trains_middle_and_fine():
    gen = torch.Generator().manual_seed(0)
    params = init_model(gen, ModelSpec(), device="cpu")
    bound = [[-1.0, 1.0], [-1.0, 1.0], [-1.0, 1.0]]
    out, losses = pretrain.pretrain_decoders_synthetic(
        gen, params, ModelSpec(), bound, steps=3, batch=256)
    assert losses.shape == (3,) and bool(torch.isfinite(losses).all())
    a, b = flat(params), flat(out)
    for k in a:
        changed = not np.array_equal(a[k], b[k])
        assert changed == k.startswith(("params/middle/", "params/fine/")), k


def test_tool_npz_read_by_both_packages(tmp_path):
    out = str(tmp_path / "dec.npz")
    tool.main(["--device", "cpu", "--scenes", "1", "--steps", "2",
               "--batch", "64", "--out", out])
    with np.load(out) as z, np.load(os.path.join(
            REPO, "pretrained", "decoders_tpu.npz")) as ref:
        keys = {k: z[k].shape for k in z.files}
        # the JAX tool's file: the same keys and shapes
        assert keys == {k: ref[k].shape for k in ref.files}
        saved = {k: z[k] for k in z.files}
    got = flat(pretrain.load_npz_decoders(out, init_model(
        torch.Generator().manual_seed(3), ModelSpec(), device="cpu")))
    want = flat(jax.tree.map(np.asarray, jpre.load_npz_decoders(
        out, jax_init_model(jax.random.PRNGKey(3), nice_model_spec()))))
    assert sorted(got) == sorted(want) == sorted(saved)
    for k in saved:
        np.testing.assert_array_equal(got[k], saved[k], err_msg=k)
        np.testing.assert_array_equal(want[k], saved[k], err_msg=k)
