"""The port's GPipe schedule (``parallel/pipeline.py``) and tensor
parallelism (``parallel/mesh.py::tensor_parallel``) against the JAX
package's, on the CPU, over 4 gloo ranks (``tests/_torch_dist_worker.py``:
``file://`` rendezvous, one torch thread each, joins under a timeout that
kills the ranks). The JAX references run once in this process and reach
the ranks through one ``.npz``.

  * the four-stage harness of other widths and ranks against JAX's
    ``pipeline_apply`` on its 4-device 'stage' mesh
    (``tests/test_train.py:470-507``), for n_micro 4 and 8, with equal
    ``stage_io_shapes``;
  * its gradients (``:534-562``): input and first-stage weight, rtol 1e-5
    / atol 1e-6;
  * I3D in 4 stages against JAX's unsharded ``model.apply`` at
    8x16x64x64 (``:510-531``, rtol 2e-3 / atol 1e-5);
  * I3D on a 2x2 (data, model) mesh against the same forward (``:404-426``,
    rtol 2e-3 / atol 1e-4) on the plain route, the pointwise-kernel route
    with the fused 1x1x1 trio, and the fused branch 3.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ivf_tpu.models import i3d_smth as j_i3d_smth
from ivf_tpu.parallel import get_mesh as j_get_mesh
from ivf_tpu.parallel.pipeline import pipeline_apply as j_pipeline_apply
from ivf_tpu.parallel.pipeline import stage_io_shapes as j_stage_io_shapes
from ivf_tpu_torch.utils.convert import variables_to_state_dict
from tests import _torch_dist_worker as worker

I3D_SHAPE = (8, 16, 64, 64, 3)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The inputs (numpy, seeded), JAX's results, and the ranks' outputs of
    the ``pipeline`` and ``tp`` scenarios."""
    work = tmp_path_factory.mktemp("pipeline")
    rng = np.random.RandomState(0)
    data = {
        "w1": rng.randn(6, 10) * 0.3, "w2": rng.randn(10, 3) * 0.3, "w3": rng.randn(12, 5) * 0.3,
        "x": rng.randn(8, 6), "g_x": rng.randn(8, 8), **{f"g_w{i}": rng.randn(8, 8) * 0.3 for i in range(4)},
        "clips": rng.randn(*I3D_SHAPE),
    }
    data = {k: v.astype(np.float32) for k, v in data.items()}
    w1, w2, w3 = (jnp.asarray(data[k]) for k in ("w1", "w2", "w3"))
    stages = [
        lambda x: jnp.tanh(x @ w1),
        lambda x: jnp.concatenate([x @ w2, x[:, :1]], -1),
        lambda x: (x[:, None, :] * x[:, :, None]).reshape(x.shape[0], -1)[:, :12],
        lambda x: jax.nn.softmax(x @ w3, -1),
    ]
    mesh = j_get_mesh(4, axis_name="stage")
    want = {"shapes": [list(s.shape) for s in j_stage_io_shapes(stages, (1, 6))]}
    for n_micro in (4, 8):
        want[f"harness_{n_micro}"] = np.asarray(j_pipeline_apply(stages, jnp.asarray(data["x"]), mesh, n_micro=n_micro))
    ws = [jnp.asarray(data[f"g_w{i}"]) for i in range(4)]
    st = [lambda x, w=w: jnp.tanh(x @ w) for w in ws]

    def pp_loss(x, w0):
        return jnp.sum(j_pipeline_apply([lambda a: jnp.tanh(a @ w0)] + st[1:], x, mesh, n_micro=4) ** 2)

    gx, gw = jax.jit(jax.grad(pp_loss, argnums=(0, 1)))(jnp.asarray(data["g_x"]), ws[0])
    want["grad_x"], want["grad_w0"] = np.asarray(gx), np.asarray(gw)
    model = j_i3d_smth(num_classes=8, dropout_rate=0.0, pool_shape=(2, 2, 2))
    clips = jnp.asarray(data["clips"])
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), clips[:1])
    want["i3d"] = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, clips))
    sd = variables_to_state_dict(variables)
    np.savez(work / "pp_in.npz", **data, **{f"sd/{k}": v.numpy() for k, v in sd.items()})
    worker.run_world("pipeline", 4, work)
    worker.run_world("tp", 4, work)
    with open(work / "pp_out.pkl", "rb") as f:
        pp = pickle.load(f)
    with open(work / "tp_out.pkl", "rb") as f:
        tp = pickle.load(f)
    return {"want": want, "pp": pp, "tp": tp}


@pytest.mark.parametrize("n_micro", [4, 8])
def test_pipeline_harness_matches_jax(refs, n_micro):
    """The 4-stage harness against JAX's ``pipeline_apply`` (rtol 1e-6 /
    atol 1e-7, the JAX test's), the same result on every rank, and the
    stages' shapes equal to JAX's ``stage_io_shapes``."""
    got, want = refs["pp"], refs["want"]
    assert got["shapes"] == want["shapes"] == [[1, 6], [1, 10], [1, 4], [1, 12], [1, 5]]
    assert got[f"harness_{n_micro}_same_on_every_rank"]
    np.testing.assert_allclose(got[f"harness_{n_micro}"], want[f"harness_{n_micro}"], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["grad_x", "grad_w0"])
def test_pipeline_gradients_match_jax(refs, name):
    """A backward through the schedule (4 stages, 4 microbatches) against
    JAX's gradient of its pipelined loss: rtol 1e-5 / atol 1e-6."""
    np.testing.assert_allclose(refs["pp"][name], refs["want"][name], rtol=1e-5, atol=1e-6)


def test_pipeline_i3d_matches_jax_forward(refs):
    """I3D cut into 4 stages (``i3d_stage_fns``), 8 microbatches of one clip,
    against JAX's unsharded forward at 8x16x64x64: rtol 2e-3 / atol 1e-5."""
    np.testing.assert_allclose(refs["pp"]["i3d"], refs["want"]["i3d"], rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("route", list(worker.TP_ROUTES))
def test_tensor_parallel_i3d_matches_jax_forward(refs, route):
    """I3D with every divisible unit sliced over 'model' (58 units) and the
    batch over 'data', the outputs gathered, against JAX's unsharded
    forward of the same 4 clips: rtol 2e-3 / atol 1e-4; every rank holds
    the same logits."""
    tp = refs["tp"]
    assert tp[f"{route}_sliced_units"] == 58 and tp[f"{route}_same_on_every_rank"]
    np.testing.assert_allclose(tp[route], refs["want"]["i3d"][:4], rtol=2e-3, atol=1e-4)
