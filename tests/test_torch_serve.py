"""ivf_tpu_torch.serve against ivf_tpu.serve on the CPU: artifacts, the
dynamic batcher, the HTTP endpoint and the command line.

The cases of tests/test_serve.py, ported with their tolerances, on the
same tiny ConvLSTM (``CLIP = (6, 16, 16, 3)``) on its gate-kernel route,
whose gate forward is a custom op of the exported graph (on CPU tensors
the op runs the plain version); then the port's artifacts against JAX's
``export_forward(...).call`` on the same numpy-drawn weights (carried
across with ``utils/convert.py``), the tiny ConvLSTM and the SMALL I3D of
tests/test_torch_model.py at (8, 32, 32, 3), within the port's model-test
tolerances (ConvLSTM logits rtol 1e-4 / atol 1e-5,
tests/test_torch_convlstm.py; I3D logits rtol 1e-3 / atol 1e-4,
tests/test_torch_model.py); the custom-op nodes of each route's graph
(the CPU proof that an artifact cannot run a plain version on the card in
a kernel's place); the ops themselves (``torch.library.opcheck``); each
package refusing the other's artifacts; and the command line's
``export-model`` / ``serve``. The card's cases are in
tests/test_torch_gpu.py.
"""

import io
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ivf_tpu.models import I3D as JI3D
from ivf_tpu.models.convlstm import ConvLSTMClassifier as JClassifier
from ivf_tpu.serve import export_forward as j_export_forward
from ivf_tpu.serve import load_artifact as j_load_artifact
from ivf_tpu.serve import save_artifact as j_save_artifact
from ivf_tpu_torch import cli
from ivf_tpu_torch.models import I3D as TI3D
from ivf_tpu_torch.models import ConvLSTMClassifier as TClassifier
from ivf_tpu_torch.ops.kernels import custom_ops
from ivf_tpu_torch.serve import (
    DynamicBatcher,
    export_forward,
    live_forward,
    load_artifact,
    save_artifact,
    serve_http,
)
from ivf_tpu_torch.utils.convert import convlstm_variables_to_state_dict, i3d_variables_to_state_dict

CLIP = (6, 16, 16, 3)
TINY = dict(num_classes=4, nb_lstm_units=4, lstm_layers=1, conv_kernel_size=3, effective_steps=(2, 5),
            dropout_rate=0.0, add_softmax=True)
I3D_CLIP = (8, 32, 32, 3)
SMALL = dict(num_classes=5, pool_shape=(1, 1, 1))
I3D_ROUTES = {
    "stock": {},
    "kernels": dict(use_pallas=True, pallas_pool=True),
    "frame": dict(use_pallas=True, fuse_pool_conv=True),
    "tblock": dict(use_pallas=True, fuse_pool_conv="tblock"),
}
OP = "ivf_tpu_torch."
# the custom-op nodes of each route's exported graph: one per launch of a
# forward (9 Inception blocks, 20 pointwise convs of which 9 are branch 3's;
# the tiny ConvLSTM's 6 steps of 1 layer)
GRAPH_OPS = {
    "i3d_stock": {},
    "i3d_kernels": {"pw_gemm_f32": 20, "maxpool3d_s1_fwd_f32": 9},
    "i3d_frame": {"pw_gemm_f32": 11, "fused_pool_conv_fwd_f32": 9},
    "i3d_tblock": {"pw_gemm_f32": 11, "fused_pool_conv_tblock_fwd_f32": 9},
    "clstm_gates": {"lstm_gates_fwd_f32": 6},
    "clstm_stock": {},
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: where test workers share the cores, threads
    that wait on each other make the port's runs many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_variables(model, shape, seed=0):
    """Numpy-drawn variables (BN statistics included): unit-fan-in kernels,
    the logits kernel scaled down so the softmax is not saturated."""
    rng = np.random.RandomState(seed)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, *shape)))

    def fill(path, leaf):
        names = [getattr(p, "key", None) for p in path]
        if names[-1] in ("wx", "wh", "kernel"):
            k = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
            return (k * (0.01 if "logits" in names else 1.0)).astype(np.float32)
        if names[-1] in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _tiny(use_pallas=True, variables=None):
    model = TClassifier(**TINY, use_pallas=use_pallas, input_size=CLIP[1:3], clip_len=CLIP[0])
    model.load_state_dict(convlstm_variables_to_state_dict(variables))
    return model.eval()


@pytest.fixture(scope="module")
def jax_tiny():
    model = JClassifier(**TINY)
    return model, _jax_variables(model, CLIP)


@pytest.fixture(scope="module")
def tiny_model(jax_tiny):
    """The port's tiny ConvLSTM on the gate-kernel route."""
    return _tiny(True, jax_tiny[1])


@pytest.fixture(scope="module")
def tiny_program(tiny_model):
    """Its batch-polymorphic export, once for the module."""
    return export_forward(tiny_model, CLIP)


@pytest.fixture(scope="module")
def tiny_artifact(tiny_program, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("art") / "clstm.ivfptx")
    save_artifact(tiny_program, path, meta={"family": "clstm", "num_classes": 4, "clip_shape": list(CLIP)})
    return path


# -- the cases of tests/test_serve.py ------------------------------------------


def test_artifact_roundtrip_matches_live(tiny_model, tiny_artifact):
    """save_artifact -> load_artifact reproduces the live forward, without
    the model object (tolerance of tests/test_serve.py; the bits are
    equal)."""
    call, meta = load_artifact(tiny_artifact)
    assert meta["family"] == "clstm"
    x = np.random.RandomState(0).randn(3, *CLIP).astype(np.float32)
    live = tiny_model(torch.from_numpy(x)).detach().numpy()
    aot = call(x).numpy()
    np.testing.assert_allclose(aot, live, rtol=1e-6, atol=1e-7)
    assert np.array_equal(aot, live)


def test_artifact_batch_polymorphic(tiny_program):
    """One artifact serves several batch sizes (symbolic leading dim),
    batch 1 included though the trace saw 2."""
    for b in (1, 2, 5):
        out = tiny_program.module()(torch.zeros((b, *CLIP)))
        assert out.shape == (b, 4)


def test_artifact_static_batch(tiny_model):
    """static_batch=N exports exactly batch N (the CLI --static-batch
    path); another batch is rejected."""
    program = export_forward(tiny_model, CLIP, batch_polymorphic=False, static_batch=3)
    out = program.module()(torch.zeros((3, *CLIP)))
    assert out.shape == (3, 4)
    with pytest.raises(Exception):
        program.module()(torch.zeros((2, *CLIP)))


def test_batcher_survives_bad_request(tiny_model):
    """A request of another shape fails its batch's futures but not the
    worker thread: later requests still serve."""
    good = np.zeros(CLIP, np.float32)
    bad = np.zeros((2, *CLIP[1:]), np.float32)  # different T
    # a generous wait, so both requests coalesce into one batch and
    # np.stack (not infer_fn) is the failing step
    with DynamicBatcher(live_forward(tiny_model), max_batch=4, max_wait_ms=500) as b:
        f_bad = b.submit(bad)
        f_good = b.submit(good)
        with pytest.raises(Exception):
            f_bad.result(timeout=60)
        with pytest.raises(Exception):
            f_good.result(timeout=60)
        out = b.submit(good).result(timeout=60)
        assert out.shape == (4,)


def test_batcher_warmup_runs_every_bucket(tiny_model):
    calls = []
    infer = live_forward(tiny_model)

    def counted(x):
        calls.append(tuple(x.shape))
        return infer(x)

    with DynamicBatcher(counted, max_batch=4, max_wait_ms=1) as b:
        b.warmup(CLIP)
        assert calls == [(1, *CLIP), (2, *CLIP), (4, *CLIP)]
        assert b.submit(np.zeros(CLIP, np.float32)).result(timeout=60).shape == (4,)


def test_artifact_rejects_garbage(tmp_path):
    p = tmp_path / "junk.ivfptx"
    p.write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="not an ivf_tpu_torch artifact"):
        load_artifact(str(p))


def test_batcher_results_match_direct(tiny_model):
    """Concurrent submits through the batcher equal direct per-clip
    inference; padding rows never leak into results."""
    infer = live_forward(tiny_model)
    clips = np.random.RandomState(1).randn(13, *CLIP).astype(np.float32)
    direct = infer(clips).numpy()

    with DynamicBatcher(infer, max_batch=8, max_wait_ms=20) as batcher:
        futs = []

        def submit_range(lo, hi):
            for i in range(lo, hi):
                futs.append((i, batcher.submit(clips[i])))

        ts = [threading.Thread(target=submit_range, args=(0, 7)),
              threading.Thread(target=submit_range, args=(7, 13))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        results = {i: np.asarray(f.result(timeout=60)) for i, f in futs}

    for i in range(13):
        np.testing.assert_allclose(results[i], direct[i], rtol=1e-5, atol=1e-6)
    s = batcher.stats
    assert s.requests == 13
    assert s.rows == 13
    assert s.batches >= 2  # 13 requests do not fit one max_batch=8 batch
    assert 0 < s.occupancy() <= 1
    assert len(s.latencies_ms) == 13


def test_batcher_bucket_padding():
    """A single request pads to the smallest bucket, not max_batch."""
    seen = []

    def infer(x):
        seen.append(x.shape[0])
        return np.zeros((x.shape[0], 2), np.float32)

    with DynamicBatcher(infer, max_batch=16, max_wait_ms=1) as b:
        assert b.buckets == [1, 2, 4, 8, 16]
        b.submit(np.zeros(CLIP, np.float32)).result(timeout=30)
    assert seen == [1]
    assert b.stats.padded_rows == 0


def test_batcher_latency_bounded_under_steady_rate():
    """Under a steady rate below capacity, latency stays bounded by
    max_wait + the service time in flight, not by the queue's depth: the
    fake forward costs ~5 ms, a request comes every ~5 ms, the wait cap is
    10 ms (tests/test_serve.py's bounds, kept)."""

    def infer(x):
        time.sleep(0.005)
        return np.zeros((x.shape[0], 4), np.float32)

    with DynamicBatcher(infer, max_batch=8, max_wait_ms=10) as b:
        futs = []
        for _ in range(80):
            futs.append(b.submit(np.zeros(CLIP, np.float32)))
            time.sleep(0.005)
        for f in futs:
            f.result(timeout=30)
    s = b.stats.summary()
    assert s["requests"] == 80
    assert s["latency_ms_p50"] <= 100, s
    assert s["latency_ms_p95"] <= 250, s


def test_batcher_propagates_errors():
    def infer(x):
        raise RuntimeError("boom")

    with DynamicBatcher(infer, max_batch=4, max_wait_ms=1) as b:
        fut = b.submit(np.zeros(CLIP, np.float32))
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=30)
    assert b.stats.batches == 0  # the batcher survives a failing batch


def _clstm_cfg_file(tmp_path, name="serve_smoke", **extra):
    cfg = {"model_name": name, "output_dir": str(tmp_path), "conv_model": "clstm", "num_classes": 3,
           "clip_size": 5, "input_spatial_size": 16, "clstm_hidden": 4, "clstm_layers": 1, "dropout": 0.0, **extra}
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _smoke_response(out: str) -> dict:
    return json.loads(out.split("smoke response: ", 1)[1].splitlines()[0])


def test_cli_export_then_serve_smoke(tmp_path, capsys):
    """``cli export-model`` writes an artifact; ``cli serve --artifact
    --smoke`` serves it over HTTP, posts one request and exits: the
    deployment path end to end with no model code on the serving side.
    With no ``--device`` the artifact runs on the device in its meta; a
    ``--device`` naming another raises before serving."""
    cfg_path = _clstm_cfg_file(tmp_path, use_pallas=True)
    art = str(tmp_path / "clstm.ivfptx")
    cli.main(["export-model", "-c", cfg_path, "--out", art, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "exported" in out and art in out and "device cpu" in out
    cli.main(["serve", "--artifact", art, "--port", "0", "--max-batch", "4", "--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "serving on http://" in out
    resp = _smoke_response(out)
    assert len(resp["scores"]) == 3
    assert resp["top1"] == int(np.argmax(resp["scores"]))
    assert cli.main(["serve", "--artifact", art, "--port", "0", "--max-batch", "4", "--smoke"]) == resp
    with pytest.raises(ValueError, match="runs on cpu, not on --device cuda"):
        cli.main(["serve", "--artifact", art, "--port", "0", "--smoke", "--device", "cuda"])


def test_http_endpoint(tiny_model):
    """POST /predict with an npy body -> scores + top1; /stats and
    /healthz respond."""
    infer = live_forward(tiny_model)
    clip = np.random.RandomState(2).randn(*CLIP).astype(np.float32)
    expect = infer(clip[None]).numpy()[0]

    with DynamicBatcher(infer, max_batch=4, max_wait_ms=1) as batcher:
        server = serve_http(batcher, port=0)
        try:
            host, port = server.server_address
            buf = io.BytesIO()
            np.save(buf, clip)
            req = urllib.request.Request(f"http://{host}:{port}/predict", data=buf.getvalue())
            resp = json.loads(urllib.request.urlopen(req, timeout=60).read())
            np.testing.assert_allclose(np.asarray(resp["scores"]), expect, rtol=1e-5, atol=1e-6)
            assert resp["top1"] == int(np.argmax(expect))
            stats = json.loads(urllib.request.urlopen(f"http://{host}:{port}/stats", timeout=30).read())
            assert stats["requests"] == 1
            health = json.loads(urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=30).read())
            assert health["ok"] is True
        finally:
            server.shutdown()


# -- against JAX's artifacts ------------------------------------------------------


@pytest.fixture(scope="module")
def jax_i3d():
    model = JI3D(**SMALL, dropout_rate=0.0)
    return model, _jax_variables(model, I3D_CLIP)


@pytest.fixture(scope="module")
def jax_i3d_export(jax_i3d):
    return j_export_forward(*jax_i3d, I3D_CLIP)


@pytest.fixture(scope="module")
def i3d_programs(jax_i3d):
    """The port's SMALL I3D on each route, with JAX's weights, exported once."""
    sd = i3d_variables_to_state_dict(jax_i3d[1])
    out = {}
    for route, flags in I3D_ROUTES.items():
        model = TI3D(**SMALL, **flags)
        model.load_state_dict(sd)
        out[route] = (model.eval(), export_forward(model.eval(), I3D_CLIP))
    return out


@pytest.mark.parametrize("route", ["stock", "kernels", "tblock"])
def test_i3d_artifact_matches_jax_export(jax_i3d_export, i3d_programs, route, tmp_path):
    """The port's I3D artifact (saved and loaded) against JAX's exported
    forward at batches 1, 2 and 5: logits rtol 1e-3 / atol 1e-4, the
    port's I3D tolerance against JAX (tests/test_torch_model.py)."""
    path = str(tmp_path / "i3d.ivfptx")
    save_artifact(i3d_programs[route][1], path)
    call, _ = load_artifact(path)
    rng = np.random.RandomState(3)
    for b in (1, 2, 5):
        x = rng.uniform(0, 255, (b, *I3D_CLIP)).astype(np.float32)
        np.testing.assert_allclose(call(x).numpy(), np.asarray(jax_i3d_export.call(x)), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["gates", "stock"])
def test_clstm_artifact_matches_jax_export(jax_tiny, use_pallas, tmp_path):
    """The port's tiny ConvLSTM artifact against JAX's exported forward at
    batches 1, 2 and 5: rtol 1e-4 / atol 1e-5, the port's ConvLSTM
    tolerance against JAX (tests/test_torch_convlstm.py)."""
    jmodel, variables = jax_tiny
    jexp = j_export_forward(jmodel, variables, CLIP)
    path = str(tmp_path / "clstm.ivfptx")
    save_artifact(export_forward(_tiny(use_pallas, variables), CLIP), path)
    call, _ = load_artifact(path)
    rng = np.random.RandomState(4)
    for b in (1, 2, 5):
        x = rng.rand(b, *CLIP).astype(np.float32)
        np.testing.assert_allclose(call(x).numpy(), np.asarray(jexp.call(x)), rtol=1e-4, atol=1e-5)


# -- the custom ops -------------------------------------------------------------------


def _graph_ops(program) -> dict:
    ops = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith(OP):
            name = str(node.target)[len(OP):].rsplit(".", 1)[0]
            ops[name] = ops.get(name, 0) + 1
    return ops


@pytest.mark.parametrize("case", list(GRAPH_OPS))
def test_graph_holds_the_kernel_ops_of_its_route(case, i3d_programs, tiny_program, jax_tiny, tmp_path):
    """Each kernel route's exported graph (after save and load) calls the
    custom op of every float32 forward kernel its flags reach, once per
    launch, and nothing else of the namespace; the stock routes call none.
    The op picks kernel or plain version when the program runs, so an
    artifact exported here launches the kernels on the card."""
    family, route = case.split("_")
    if family == "i3d":
        program = i3d_programs[route][1]
    else:
        program = tiny_program if route == "gates" else export_forward(_tiny(False, jax_tiny[1]), CLIP)
    path = str(tmp_path / "a.ivfptx")
    save_artifact(program, path)
    call, _ = load_artifact(path)
    assert _graph_ops(call.program) == GRAPH_OPS[case]


def _op_inputs(name):
    gen = torch.Generator().manual_seed(5)

    def r(*shape):
        return torch.randn(*shape, generator=gen)

    if name == "pw_gemm_f32":  # W as the (Cout, Cin) weight's transposed view, as Unit3D passes it
        return [(r(37, 12), r(8, 12).t(), r(8), True), (r(3, 12), r(8, 12).t(), None, False)]
    if name == "maxpool3d_s1_fwd_f32":
        return [(r(2, 3, 4, 5, 6),)]
    if name.startswith("fused_pool_conv"):
        return [(r(2, 3, 4, 5, 6), r(6, 7), r(7), True), (r(1, 2, 3, 3, 4), r(4, 5), r(5), False)]
    return [(r(2, 3, 4, 16), r(2, 3, 4, 16), r(2, 3, 4, 4)), (r(2, 3, 4, 16), None, r(2, 3, 4, 4))]


OP_PLAIN = {
    "pw_gemm_f32": "ivf_tpu_torch.ops.kernels.pointwise_conv:pointwise_conv_plain",
    "maxpool3d_s1_fwd_f32": "ivf_tpu_torch.ops.kernels.maxpool3d:maxpool3d_s1_fwd_plain",
    "fused_pool_conv_fwd_f32": "ivf_tpu_torch.ops.kernels.fused_branch3:fused_pool_conv_plain",
    "fused_pool_conv_tblock_fwd_f32": "ivf_tpu_torch.ops.kernels.fused_branch3:fused_pool_conv_plain",
    "lstm_gates_fwd_f32": "ivf_tpu_torch.ops.kernels.fused_gates:gate_math_plain",
}


@pytest.mark.parametrize("name", list(OP_PLAIN))
def test_custom_op_is_the_plain_version_on_cpu_tensors(name):
    """Each op on CPU tensors gives the plain version's bits, and passes
    ``torch.library.opcheck`` (schema, fake shapes, dispatch)."""
    import importlib

    module, fn = OP_PLAIN[name].split(":")
    plain = getattr(importlib.import_module(module), fn)
    op = getattr(torch.ops.ivf_tpu_torch, name)
    for args in _op_inputs(name):
        got = op(*args)
        want = plain(*((args[0], args[1].contiguous(), *args[2:]) if name == "pw_gemm_f32" else args))
        for g, w in zip(*(((got,), (want,)) if isinstance(got, torch.Tensor) else (got, want))):
            assert torch.equal(g, w)
        torch.library.opcheck(op, args)


def test_eager_wrappers_launch_directly_and_raise_on_other_devices():
    """Outside a trace the wrappers take their direct routes (the op only
    under ``torch.export``); a meta tensor reaches no plain version."""
    assert not torch.compiler.is_exporting()
    assert not custom_ops.through_op("pointwise_conv", torch.zeros(1))
    from ivf_tpu_torch.ops.kernels.pointwise_conv import pointwise_conv

    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        pointwise_conv(torch.zeros(4, 3, device="meta"), torch.zeros(3, 2, device="meta"))


@pytest.mark.parametrize("model", ["i3d", "clstm"])
def test_export_of_a_bf16_kernel_route_raises(model, jax_tiny):
    """The bfloat16 kernels have no custom op: exporting a bf16 kernel
    route raises instead of recording their plain versions."""
    if model == "i3d":
        net, shape = TI3D(**SMALL, use_pallas=True, pallas_pool=True), I3D_CLIP
        net.reset_parameters(torch.Generator().manual_seed(0))
    else:
        net, shape = _tiny(True, jax_tiny[1]), CLIP
    net = net.to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="no custom op for torch.bfloat16"):
        export_forward(net, shape, dtype=torch.bfloat16)


# -- the artifact file -------------------------------------------------------------------


def test_meta_records_the_device_and_input(tiny_artifact):
    _, meta = load_artifact(tiny_artifact)
    assert meta["device"] == "cpu"
    assert meta["clip_shape"] == list(CLIP) and meta["num_classes"] == 4
    assert len(meta["in_specs"]) == 1 and meta["in_specs"][0].startswith("float32[")
    assert meta["in_specs"][0].endswith(", 6, 16, 16, 3]")


def test_a_jax_artifact_is_refused_and_jax_refuses_ours(jax_tiny, tiny_artifact, tmp_path):
    """Each package refuses the other's artifacts with a clear error."""
    jmodel, variables = jax_tiny
    jpath = str(tmp_path / "clstm.ivfaot")
    j_save_artifact(j_export_forward(jmodel, variables, CLIP), jpath, meta={"family": "clstm"})
    with pytest.raises(ValueError, match=r"JAX artifact of the ivf_tpu package \(jax.export"):
        load_artifact(jpath)
    with pytest.raises(ValueError, match="not an ivf_tpu AOT artifact"):
        j_load_artifact(tiny_artifact)


def test_a_cuda_artifact_without_a_card_raises(tiny_program, tmp_path, monkeypatch):
    """An artifact exported for the card never runs on the CPU in its
    place: with no CUDA device, loading it raises."""
    path = str(tmp_path / "cuda.ivfptx")
    save_artifact(tiny_program, path, meta={"device": "cuda:0", "clip_shape": list(CLIP)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="exported for cuda:0, and this host has no CUDA device"):
        load_artifact(path)


def test_export_on_another_device_raises(tiny_model):
    with pytest.raises(ValueError, match="the model is on cpu, not cuda"):
        export_forward(tiny_model, CLIP, device="cuda")


def test_forwards_run_without_grad_inside_reference_numerics():
    """A served forward runs under no_grad with TF32 off and deterministic
    cuDNN, whatever the caller's flags; the caller's flags come back."""
    seen = []

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(1))

        def forward(self, x):
            seen.append((torch.is_grad_enabled(), torch.backends.cudnn.allow_tf32,
                         torch.backends.cudnn.deterministic))
            return x * self.w

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = True, False
    try:
        live_forward(Probe())(np.zeros((2, 3), np.float32))
        assert seen == [(False, False, True)]
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic) == (True, False)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = saved


# -- the command line --------------------------------------------------------------------


def test_cli_serves_the_configured_model_and_checks_the_device(tmp_path, capsys):
    """``serve`` without ``--artifact`` serves the configured model live
    (``--warmup`` runs each bucket first); a ``--device`` other than the
    artifact's raises."""
    cfg_path = _clstm_cfg_file(tmp_path, "live")
    resp = cli.main(["serve", "-c", cfg_path, "--port", "0", "--max-batch", "2", "--warmup", "--smoke",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert "warming 2 bucket programs" in out and _smoke_response(out) == resp
    art = str(tmp_path / "live.ivfptx")
    cli.main(["export-model", "-c", cfg_path, "--out", art, "--device", "cpu", "--static-batch", "1"])
    with pytest.raises(ValueError, match="runs on cpu, not on --device meta"):
        cli.main(["serve", "--artifact", art, "--smoke", "--device", "meta"])


def test_cli_export_matches_the_jax_export(tmp_path, capsys):
    """One JSON config in both packages: JAX's ``init_eval_state`` weights,
    written as a reference checkpoint, read by the port's ``export-model
    --checkpoint``; its artifact against JAX's exported forward on the
    same weights, rtol 1e-4 / atol 1e-5 (the ConvLSTM tolerance above)."""
    from ivf_tpu.api import init_eval_state as j_init_eval_state
    from ivf_tpu.config import Config as JConfig
    from ivf_tpu.utils.export_torch import convlstm_variables_to_state_dict as j_reference_sd
    from ivf_tpu.utils.export_torch import save_checkpoint_file

    cfg_path = _clstm_cfg_file(tmp_path, "both")
    jmodel, jstate = j_init_eval_state(JConfig.load(cfg_path), softmax_override=True)
    variables = jstate.variables()
    ckpt = str(tmp_path / "both.pth.tar")
    sd = j_reference_sd(variables, image_size=(16, 16), conv_stride=1, pool_kernel=(2, 2), lstm_layers=1,
                        nb_lstm_units=4)
    save_checkpoint_file(ckpt, sd, arch="clstm")
    art = str(tmp_path / "both.ivfptx")
    cli.main(["export-model", "-c", cfg_path, "--out", art, "--device", "cpu", "--checkpoint", ckpt])
    capsys.readouterr()
    call, meta = load_artifact(art)
    assert {k: meta[k] for k in ("family", "num_classes", "clip_shape", "device")} == {
        "family": "clstm", "num_classes": 3, "clip_shape": [5, 16, 16, 3], "device": "cpu"}
    x = np.random.RandomState(5).rand(2, 5, 16, 16, 3).astype(np.float32)
    want = np.asarray(j_export_forward(jmodel, variables, (5, 16, 16, 3)).call(x))
    np.testing.assert_allclose(call(x).numpy(), want, rtol=1e-4, atol=1e-5)
