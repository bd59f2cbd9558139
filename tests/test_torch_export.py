"""The port's export (``layoutdit_tpu_torch/export.py``) on the CPU, tiny
widths, weights carried from the JAX package: the kernels' registered
operators in a traced program (fake CUDA inputs), a CPU artifact loaded
in a process that imports no model, config or eval code against the live
engine (boxes 1e-5, scores 1e-6, labels exact) and against JAX's own
exported artifact of the same weights (boxes 1e-3, scores 1e-4, matched
as sets, as ``tests/test_torch_detector.py`` matches NMS ties), bucket
routing and batch padding, refused artifacts, and the export tool."""

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from layoutdit_tpu import export as jax_export
from layoutdit_tpu.config.constructs import DetectionBudget as JaxBudget
from layoutdit_tpu.models import backbone as jax_backbone
from layoutdit_tpu.models import vit as jax_vit
from layoutdit_tpu.models.detection import detector as jax_det
from layoutdit_tpu_torch import export as port_export
from layoutdit_tpu_torch.config import DetectionBudget
from layoutdit_tpu_torch.models import backbone as port_backbone
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.detection.detector import params_for_inference
from layoutdit_tpu_torch.models.weights_io import params_from_jax, tree_leaves

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
VIT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, image_size=64)
BUDGET = dict(rpn_pre_nms_top_n_test=200, rpn_post_nms_top_n_test=100,
              box_detections_per_img=20)
SIZES = (64, 96)
BATCH = 2
# against JAX: the same tolerances as the detector tests
BOX_TOL, SCORE_TOL = 1e-3, 1e-4
# the kernels' operators (and the NMS) by the names a traced graph gives them
OPS = {"short": "layoutdit_torch.short_attention.default",
       "flash": "layoutdit_torch.flash_attention_fwd.default",
       "roi": "layoutdit_torch.roi_align_fwd.default",
       "nms": "layoutdit_torch.nms_fixpoint.default"}


class _JaxModel:
    def __init__(self, params, cfg):
        self.params, self.cfg = params, cfg


@pytest.fixture(scope="module")
def models():
    jcfg = jax_det.DetectorConfig(
        backbone=jax_backbone.BackboneConfig(vit=jax_vit.ViTConfig(**VIT), fpn_out_channels=32),
        image_size=64, budget=JaxBudget(**BUDGET),
    )
    pcfg = port_det.DetectorConfig(
        backbone=port_backbone.BackboneConfig(vit=port_vit.ViTConfig(**VIT), fpn_out_channels=32),
        image_size=64, budget=DetectionBudget(**BUDGET),
    )
    jparams = jax.jit(jax_det.init_detector_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    jparams["backbone"]["vit"]["pos_embed"] = 0.02 * jax.random.normal(
        jax.random.PRNGKey(1), jparams["backbone"]["vit"]["pos_embed"].shape)
    pparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return _JaxModel(jparams, jcfg), port_det.DetectorModel(pparams, pcfg)


@pytest.fixture(scope="module")
def artifact(models, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("export") / "artifact")
    manifest = port_export.export_detector(models[1].params, models[1].cfg, path,
                                           image_sizes=SIZES, batch_size=BATCH, device="cpu")
    return path, manifest


def _inputs(seed: int, size: int, b: int = BATCH):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (b, 3, size, size)).astype(np.float32)
    orig = np.array([[90.0, 70.0], [size, 1.5 * size]][:b], np.float32)
    return images, orig


def _live(pm, images, orig, size):
    cfg = dataclasses.replace(pm.cfg, image_size=size)
    with torch.no_grad():
        dets = port_det.rescale_detections(
            port_det.detector_predict(params_for_inference(pm.params, cfg.dtype),
                                      torch.from_numpy(images), cfg),
            torch.from_numpy(orig), size)
    return {k: getattr(dets, k).numpy() for k in port_export.OUTPUTS}


def _assert_same(want: dict, got: dict, box_tol: float, score_tol: float) -> None:
    """Valid detections of each image as matched sets (label, box, score)."""
    for i in range(len(want["valid"])):
        wv, gv = np.asarray(want["valid"][i]), np.asarray(got["valid"][i])
        assert wv.sum() == gv.sum() > 0
        gb, gs, gl = (np.asarray(got[k][i])[gv] for k in ("boxes", "scores", "labels"))
        used = np.zeros(len(gb), bool)
        for box, score, label in zip(*(np.asarray(want[k][i])[wv]
                                       for k in ("boxes", "scores", "labels"))):
            cand = np.nonzero((gl == label) & ~used & (np.abs(gb - box).max(axis=1) <= box_tol)
                              & (np.abs(gs - score) <= score_tol))[0]
            assert len(cand), f"no match for label {label} box {box} score {score}"
            used[cand[0]] = True


# --------------------------------------------------------------- fake CUDA

_GETITEM, _SETITEM = torch.Tensor.__getitem__, torch.Tensor.__setitem__


def _getitem(t, idx):
    """Basic indexing (ints, slices, None, Ellipsis) and integer-tensor
    indexing as dispatcher operations (select, slice, unsqueeze, index):
    a CPU-only torch cannot run ``Tensor.__getitem__`` on a fake CUDA
    tensor (its binding makes a CUDA device guard), though it traces the
    same operations."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    consumed = sum(1 for i in idx if i is not None and i is not Ellipsis)
    full = []
    for i in idx:
        full += [slice(None)] * (t.dim() - consumed) if i is Ellipsis else [i]
    out, dim, tensors = t, 0, {}
    for i in full:
        if i is None:
            out, dim = out.unsqueeze(dim), dim + 1
        elif isinstance(i, int) and not isinstance(i, bool):
            out = out.select(dim, i)
        elif isinstance(i, slice):
            out = torch.ops.aten.slice.Tensor(out, dim, *i.indices(out.shape[dim]))
            dim += 1
        elif isinstance(i, torch.Tensor) and i.dtype != torch.bool:
            tensors[dim] = i
            dim += 1
        else:
            raise NotImplementedError(f"index {i!r}")
    if tensors:
        out = torch.ops.aten.index.Tensor(out, [tensors.get(d) for d in range(max(tensors) + 1)])
    return out


def _setitem(t, idx, value):
    view = _getitem(t, idx)
    value = value if isinstance(value, torch.Tensor) else torch.full_like(view, value)
    torch.ops.aten.copy_.default(view, value)


@contextlib.contextmanager
def indexing_as_operations():
    torch.Tensor.__getitem__, torch.Tensor.__setitem__ = _getitem, _setitem
    try:
        yield
    finally:
        torch.Tensor.__getitem__, torch.Tensor.__setitem__ = _GETITEM, _SETITEM


def fake_cuda_graph_targets(params: dict, cfg, size: int, batch: int = BATCH) -> set[str]:
    """The call targets of ``detector_predict`` + ``rescale_detections``
    exported with fake CUDA inputs (bf16 leaves as the live engine casts
    them), as the card would trace it."""
    live = params_for_inference(params, torch.bfloat16)
    leaves = tree_leaves(live)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = [torch.empty(t.shape, dtype=t.dtype, device="cuda") for t in leaves]
        images = torch.empty(batch, 3, size, size, device="cuda")
        orig = torch.empty(batch, 2, device="cuda")
    program = port_export._Predict(
        live, dataclasses.replace(cfg, image_size=size, compute_dtype="bfloat16"), size)
    with torch.no_grad(), indexing_as_operations():
        exported = torch.export.export(program, (fake, images, orig))
    return {str(n.target) for n in exported.graph.nodes if n.op == "call_function"}


# 224 px: N = 197 tokens, the short route; 272 px: N = 290, the flash route
@pytest.mark.parametrize("size,route", [(224, "short"), (272, "flash")])
def test_fake_cuda_trace_holds_the_kernel_operators(models, size, route):
    targets = fake_cuda_graph_targets(models[1].params, models[1].cfg, size)
    other = "flash" if route == "short" else "short"
    assert {OPS[route], OPS["roi"], OPS["nms"]} <= targets
    assert OPS[other] not in targets
    # no library attention, no plain version (einsum: the plain attention
    # and RoIAlign's weight products)
    assert not [t for t in targets if "scaled_dot_product" in t or "einsum" in t], targets


def test_cpu_trace_holds_the_plain_versions_and_the_nms_operator(artifact):
    path, _ = artifact
    exported = torch.export.load(os.path.join(path, "predict_64.pt2"))
    targets = {str(n.target) for n in exported.graph.nodes if n.op == "call_function"}
    assert OPS["nms"] in targets and "aten.einsum.default" in targets
    assert not {OPS["short"], OPS["flash"], OPS["roi"]} & targets


# ----------------------------------------------------------------- the CPU

def test_manifest(artifact, models):
    _, manifest = artifact
    assert manifest["format"] == "layoutdit_tpu_torch.export.v1"
    assert manifest["image_sizes"] == list(SIZES) and manifest["batch_size"] == BATCH
    assert manifest["device"] == "cpu" and manifest["compute_dtype"] == "float32"
    assert manifest["num_classes"] == 5 and manifest["torch_version"] == torch.__version__
    leaves = tree_leaves(models[1].params)
    assert manifest["num_leaves"] == len(leaves) == len(manifest["leaf_dtypes"])
    assert set(manifest["export_seconds"]) == {str(s) for s in SIZES}


BLOCKED_RUN = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'layoutdit_tpu') or name.startswith(
                ('layoutdit_tpu_torch.models', 'layoutdit_tpu_torch.config',
                 'layoutdit_tpu_torch.eval')):
            raise ImportError('blocked ' + name)
sys.meta_path.insert(0, Block())
import numpy as np
from layoutdit_tpu_torch.export import ExportedDetector
det = ExportedDetector(sys.argv[1])
inputs = np.load(sys.argv[2])
out = {}
for size in det.image_sizes:
    got = det.predict(inputs[f'images_{size}'], inputs[f'orig_{size}'])
    out.update({f'{k}_{size}': v for k, v in got.items()})
np.savez(sys.argv[3], **out)
print(sorted(m for m in sys.modules if m.startswith('layoutdit_tpu_torch.')))
"""


def test_artifact_runs_without_model_code_and_equals_the_live_engine(artifact, models, tmp_path):
    path, _ = artifact
    pm = models[1]
    inputs = {}
    for seed, size in enumerate(SIZES):
        inputs[f"images_{size}"], inputs[f"orig_{size}"] = _inputs(seed, size)
    np.savez(tmp_path / "in.npz", **inputs)
    r = subprocess.run([sys.executable, "-c", BLOCKED_RUN, path, str(tmp_path / "in.npz"),
                        str(tmp_path / "out.npz")], cwd=REPO, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "layoutdit_tpu_torch.export" in r.stdout and ".models" not in r.stdout
    got = np.load(tmp_path / "out.npz")
    for size in SIZES:
        want = _live(pm, inputs[f"images_{size}"], inputs[f"orig_{size}"], size)
        np.testing.assert_array_equal(got[f"valid_{size}"], want["valid"])
        v = want["valid"]
        assert v.sum() > 0
        np.testing.assert_array_equal(got[f"labels_{size}"][v], want["labels"][v])
        np.testing.assert_allclose(got[f"boxes_{size}"][v], want["boxes"][v], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[f"scores_{size}"][v], want["scores"][v], atol=1e-6,
                                   rtol=0)


def test_artifact_matches_jax_exported_artifact(artifact, models, tmp_path):
    path, _ = artifact
    jm, _ = models
    jax_path = str(tmp_path / "jax")
    jax_export.export_detector(jm.params, jm.cfg, jax_path, image_sizes=(64,), batch_size=BATCH)
    images, orig = _inputs(5, 64)
    want = jax_export.ExportedDetector(jax_path).predict(images, orig)
    got = port_export.ExportedDetector(path).predict(images, orig)
    _assert_same(want, got, BOX_TOL, SCORE_TOL)


def test_size_routing_and_batch_padding(artifact, models):
    path, _ = artifact
    det = port_export.ExportedDetector(path)
    assert det.image_sizes == list(SIZES)
    for seed, size in enumerate(SIZES):
        images, orig = _inputs(seed, size)
        got = det.predict(images, orig)
        # each size runs its own bucket: the live predict of that size
        want = _live(models[1], images, orig, size)
        np.testing.assert_array_equal(got["valid"], want["valid"])
        # a tail batch padded with a zero page: the real page's detections
        # do not change
        padded = det.predict(np.concatenate([images[:1], np.zeros_like(images[:1])]),
                             np.concatenate([orig[:1], np.ones((1, 2), np.float32)]))
        for k in port_export.OUTPUTS:
            np.testing.assert_array_equal(padded[k][0], got[k][0])
    with pytest.raises(ValueError, match="no exported bucket for size 80"):
        det.predict(*_inputs(0, 80))
    # the programs' graphs are out of the cyclic collector's reach
    nodes = sum(len(fn.graph.nodes) for fn in det._fns.values())
    assert gc.get_freeze_count() > nodes


def test_constants_move_to_the_device_once():
    """A program traced for another device than the host's (here meta, as
    the card's is for cuda) holds its constants on the host and copies
    them on every call; ``constants_on`` moves them to that device and
    drops the checks of their host placement, and the program runs."""
    table = np.arange(6, dtype=np.float32)

    class Scale(torch.nn.Module):
        def forward(self, x):
            return x * torch.from_numpy(table).to(x.device) + 1.0

    x = torch.ones(6, device="meta")
    with torch.no_grad():
        module = torch.export.export(Scale(), (x,)).module()

    def constants(m):
        return [getattr(m, n.target) for n in m.graph.nodes if n.op == "get_attr"]

    def host_checks(m):
        return [n for n in m.graph.nodes
                if n.target is torch.ops.aten._assert_tensor_metadata.default
                and n.kwargs.get("device") == torch.device("cpu")]

    assert [t.device.type for t in constants(module)] == ["cpu"] and host_checks(module)
    module = port_export.constants_on(module, torch.device("meta"))
    assert [t.device.type for t in constants(module)] == ["meta"] and not host_checks(module)
    out = module(x)
    assert out.device.type == "meta" and out.shape == (6,)


def test_bad_artifacts_raise(artifact, tmp_path, monkeypatch):
    path, manifest = artifact
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "manifest.json").write_text(json.dumps({**manifest, "format": "layoutdit_tpu.export.v1"}))
    with pytest.raises(ValueError, match="not a layoutdit_tpu_torch.export.v1 artifact"):
        port_export.ExportedDetector(str(bad))
    (bad / "manifest.json").write_text(json.dumps({**manifest, "device": "cuda"}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_export.ExportedDetector(str(bad))
    with pytest.raises(FileNotFoundError):
        port_export.ExportedDetector(str(tmp_path / "missing"))
    # a CPU artifact refuses the card (with a card present)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="exported for cpu; it cannot run on cuda"):
        port_export.ExportedDetector(path, device="cuda")


def test_export_refuses_cuda_without_a_gpu(models, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_export.export_detector(models[1].params, models[1].cfg, str(tmp_path), device="cuda")


def test_export_tool(tmp_path, monkeypatch):
    from layoutdit_tpu_torch.tools import export_model
    from layoutdit_tpu_torch.tools.make_fixture import write_fixture_config

    monkeypatch.setenv("LAYOUTDIT_CONFIG", write_fixture_config(str(tmp_path), tiny_model=True))
    out = tmp_path / "artifact"
    manifest = export_model.main(["--out", str(out), "--sizes", "64", "--batch-size", "1",
                                  "--device", "cpu"])
    assert manifest["image_sizes"] == [64] and manifest["device"] == "cpu"
    assert sorted(os.listdir(out)) == ["manifest.json", "params.npz", "predict_64.pt2"]
    det = port_export.ExportedDetector(str(out))
    got = det.predict(*_inputs(0, 64, b=1))
    assert got["boxes"].shape == (1, 50, 4) and np.isfinite(got["boxes"]).all()
    with pytest.raises(SystemExit, match="queue 1 item 6"):
        export_model.main(["--out", str(out), "--int8", "--device", "cpu"])
    # the card unless the caller asks for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_model.main(["--out", str(out), "--sizes", "64"])


# ------------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_artifact_launches_the_kernels_and_equals_the_live_predict(cuda, tmp_path):
    """A ``cuda`` artifact of a narrow bf16 detector (head dim 64, as the
    kernels take it) at 64 px (the short kernels) and 272 px (N = 290, the
    flash kernels): its programs launch the kernels through their
    operators, and its detections equal the live predict's on the card
    (labels equal, boxes 1e-2 px, scores 1e-3, as ``chip_smoke.py``'s
    phase ``deploy`` holds them)."""
    from layoutdit_tpu_torch.ops import flash_attention as fa
    from layoutdit_tpu_torch.ops import roi_align as ra
    from layoutdit_tpu_torch.ops import short_attention as sa

    vit = dict(VIT, hidden_size=128, num_attention_heads=2)
    cfg = port_det.DetectorConfig(
        backbone=port_backbone.BackboneConfig(vit=port_vit.ViTConfig(**vit), fpn_out_channels=32),
        image_size=64, budget=DetectionBudget(**BUDGET), compute_dtype="bfloat16")
    params = port_det.init_detector(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    path = str(tmp_path / "artifact")
    port_export.export_detector(params, cfg, path, image_sizes=(64, 272), batch_size=BATCH,
                                device="cuda")
    det = port_export.ExportedDetector(path)
    counters = (sa.short_attention, fa.flash_attention_fwd, ra.roi_align_fwd)
    for seed, (size, route) in enumerate(((64, 0), (272, 1))):
        images, orig = _inputs(seed, size)
        before = [c.launches for c in counters]
        got = det.predict(images, orig)
        launched = [c.launches - b for c, b in zip(counters, before)]
        assert launched[route] == VIT["num_hidden_layers"] and launched[2] == 1
        assert launched[1 - route] == 0
        with torch.no_grad():
            live = port_det.rescale_detections(
                port_det.detector_predict(params_for_inference(params, torch.bfloat16),
                                          torch.from_numpy(images).to(cuda),
                                          dataclasses.replace(cfg, image_size=size)),
                torch.from_numpy(orig).to(cuda), size)
        want = {k: getattr(live, k).float().cpu().numpy() if k in ("boxes", "scores")
                else getattr(live, k).cpu().numpy() for k in port_export.OUTPUTS}
        _assert_same(want, got, 1e-2, 1e-3)
