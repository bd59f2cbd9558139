"""The port's end-to-end flow on the CPU at tiny widths: mid-training
evaluation in the trainer (best tracking and ``best.pt``, the early stop,
the trackers across ``resume``, NaN evals), ``main()`` in-process (train,
score, visualize; ``--resume auto``; ``--skip-train``; the refused JAX
options), and the config's evaluation fields. The mid-training tests
follow the JAX package's ``tests/test_e2e.py``."""

import json
import logging
import math
import os

import pytest
import torch

from layoutdit_tpu.config.constructs import EvalConfig as JaxEvalConfig
from layoutdit_tpu_torch import main as port_main
from layoutdit_tpu_torch.config import (
    EvalConfig,
    get_run_config,
    load_run_config,
    run_config_from_dict,
)
from layoutdit_tpu_torch.eval.coco_eval import COCO_KEYS
from layoutdit_tpu_torch.eval.evaluator import Evaluator
from layoutdit_tpu_torch.models.model import build_model
from layoutdit_tpu_torch.models.weights_io import tree_leaves
from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config
from layoutdit_tpu_torch.train.checkpoint import load_checkpoint
from layoutdit_tpu_torch.train.trainer import Trainer

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

IMAGE_SIZE = 64  # the tiny detector on 64 px inputs: a few seconds an epoch


def _fixture(root, n_images, seed, epochs, batch_size=4, **train):
    """Pages and a tiny-model config under ``root`` -> the config path."""
    make_fixture(root, n_images=n_images, split="samples", seed=seed)
    path = write_fixture_config(root, epochs=epochs, batch_size=batch_size, tiny_model=True)
    with open(path) as f:
        raw = json.load(f)
    raw["detection_model_config"]["image_size"] = IMAGE_SIZE
    raw["train_config"].update(train)
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _trainer(path):
    rc = load_run_config(path)
    return rc, Trainer(rc, build_model(rc, device="cpu"), device="cpu")


class _Seq:
    """A stand-in evaluator whose score() returns mAPs in turn (None =
    no prediction at all)."""

    def __init__(self, values):
        self.values = iter(values)

    def score(self):
        v = next(self.values)
        return None if v is None else {"mAP": v}


# ----------------------------------------------------- mid-training eval


def test_mid_training_eval_tracks_best(tmp_path):
    root = str(tmp_path)
    _, trainer = _trainer(_fixture(root, 8, seed=1, epochs=2, eval_interval=1))
    trainer.train()
    maps = [rec.get("mAP") for rec in trainer.metrics_history]
    assert len(maps) == 2 and all(m is not None and math.isfinite(m) for m in maps)
    assert trainer.best_checkpoint_path == os.path.join(
        root, "fixture", "model_checkpoints", "best.pt")
    assert trainer.best_map == max(maps)
    with open(os.path.join(root, "fixture", "metrics", "metrics.jsonl")) as f:
        assert [json.loads(line).get("mAP") for line in f] == maps
    best = load_checkpoint(trainer.best_checkpoint_path, map_location="cpu")
    assert best["extra"]["mAP"] == trainer.best_map
    assert best["extra"]["epoch"] == best["epoch"] == 1 + maps.index(max(maps))


def test_early_stopping_on_map_plateau(tmp_path):
    _, trainer = _trainer(_fixture(str(tmp_path), 4, seed=9, epochs=10, eval_interval=1,
                                   early_stop_patience=2, checkpoint_interval=100))
    trainer._evaluator = _Seq([0.30, 0.50, 0.40, 0.45, 0.49, 0.49, 0.49])
    trainer.train()
    # peak at epoch 2, two evals without a new best (epochs 3, 4) -> stop
    assert trainer.epoch == 4
    assert trainer.best_map == 0.50
    assert trainer.best_checkpoint_path.endswith("best.pt")
    assert os.path.exists(trainer.best_checkpoint_path)
    assert len(trainer.loss_history) == 4  # epochs 5..10 never ran


def test_early_stop_state_survives_resume(tmp_path):
    path = _fixture(str(tmp_path), 4, seed=13, epochs=2, eval_interval=1, checkpoint_interval=1)
    _, trainer = _trainer(path)
    trainer._evaluator = _Seq([0.50, 0.40])  # best at epoch 1, worse at epoch 2
    trainer.train()
    assert trainer.best_map == 0.50 and trainer._evals_since_best == 1
    best_path = trainer.best_checkpoint_path

    _, t2 = _trainer(path)
    t2.resume("auto")
    assert t2.epoch == 2
    assert t2.best_map == 0.50
    assert t2.best_checkpoint_path == best_path
    assert t2._evals_since_best == 1
    # a worse eval after the resume must not overwrite best.pt
    t2._evaluator = _Seq([0.45])
    t2._mid_eval(2)
    assert t2.best_map == 0.50
    assert t2.best_checkpoint_path == best_path
    assert t2._evals_since_best == 2
    assert load_checkpoint(best_path, map_location="cpu")["extra"]["mAP"] == 0.50


def test_nan_evals_do_not_tick_patience_before_first_best(tmp_path):
    _, trainer = _trainer(_fixture(str(tmp_path), 4, seed=14, epochs=1, eval_interval=1,
                                   early_stop_patience=2))
    trainer._evaluator = _Seq([None, None])
    trainer._mid_eval(0)
    trainer._mid_eval(1)
    assert trainer._evals_since_best == 0  # no finite best yet
    assert trainer.best_checkpoint_path is None
    trainer._evaluator = _Seq([0.3, None])
    trainer._mid_eval(2)  # the first finite best
    assert trainer.best_map == 0.3
    trainer._mid_eval(3)  # a NaN after a best does tick
    assert trainer._evals_since_best == 1


# the same mAP sequences through the JAX trainer and the port's: each
# case's train config, the mAPs its stand-in evaluator returns, and its
# drive ("train"; "mid_eval": four direct _mid_eval calls; "resume":
# train, resume("auto") into a new trainer, then one more mid-eval)
MID_EVAL_CASES = {
    "plateau": ({"epochs": 10, "eval_interval": 1, "early_stop_patience": 2,
                 "checkpoint_interval": 100}, [0.30, 0.50, 0.40, 0.45, 0.49, 0.49, 0.49], "train"),
    "nan_then_stop": ({"epochs": 6, "eval_interval": 1, "early_stop_patience": 2,
                       "checkpoint_interval": 100}, [None, None, 0.3, None, 0.2, 0.9], "train"),
    "nan_mid_eval": ({"epochs": 1, "eval_interval": 1, "early_stop_patience": 2},
                     [None, None, 0.3, None], "mid_eval"),
    "resume": ({"epochs": 2, "eval_interval": 1, "checkpoint_interval": 1},
               [0.50, 0.40, 0.45], "resume"),
}


def _trackers(trainer, root):
    """What the mid-eval bookkeeping leaves, comparable across packages:
    epochs done and run, the mAP column (NaN as a string), the best mAP,
    the patience clock, and the best checkpoint's path under ``root``
    without its extension (``.pt`` in the port, ``.msgpack`` in JAX)."""
    best = trainer.best_checkpoint_path
    return {
        "epoch": trainer.epoch, "epochs_run": len(trainer.loss_history),
        "maps": [(r["epoch"], "nan" if r.get("mAP") is not None and math.isnan(r["mAP"])
                  else r.get("mAP")) for r in trainer.metrics_history],
        "best_map": trainer.best_map, "evals_since_best": trainer._evals_since_best,
        "best": None if best is None else os.path.relpath(os.path.splitext(best)[0], root),
        "best_exists": best is not None and os.path.exists(best),
    }


def _drive(make_trainer, values, drive, root):
    """Run one case's drive on trainers from ``make_trainer`` -> the
    trackers after each stage."""
    seq = _Seq(values)
    trainer = make_trainer()
    trainer._evaluator = seq
    out = []
    if drive == "mid_eval":
        for epoch in range(len(values)):
            trainer._mid_eval(epoch)
            out.append(_trackers(trainer, root))
        return out
    trainer.train()
    out.append(_trackers(trainer, root))
    if drive == "resume":
        trainer = make_trainer()
        trainer.resume("auto")
        out.append(_trackers(trainer, root))
        trainer._evaluator = seq
        trainer._mid_eval(trainer.epoch)
        out.append(_trackers(trainer, root))
    return out


@pytest.mark.parametrize("case", sorted(MID_EVAL_CASES))
def test_mid_eval_bookkeeping_matches_jax(tmp_path, case):
    """The port's trainer and JAX's ``Trainer`` fed the same mAP sequence
    by a stand-in evaluator: the same epochs run, the same mAP column, the
    same best mAP, best checkpoint and patience clock after every stage,
    the resumed trackers included."""
    from layoutdit_tpu.config import LayoutDitConfig, set_layout_dit_config
    from layoutdit_tpu.models.model import build_model as jax_build_model
    from layoutdit_tpu.train.trainer import Trainer as JaxTrainer

    train, values, drive = MID_EVAL_CASES[case]
    train = dict(train)
    epochs = train.pop("epochs")
    roots = {side: str(tmp_path / side) for side in ("jax", "port")}
    paths = {side: _fixture(root, 4, seed=21, epochs=epochs, **train)
             for side, root in roots.items()}

    port = _drive(lambda: _trainer(paths["port"])[1], values, drive, roots["port"])
    with open(paths["jax"]) as f:
        cfg = LayoutDitConfig(**json.load(f))
    set_layout_dit_config(cfg)
    try:
        jax_side = _drive(lambda: JaxTrainer(cfg, jax_build_model(cfg)), values, drive,
                          roots["jax"])
    finally:
        set_layout_dit_config(None)
    assert port == jax_side


def test_resume_auto_falls_back_past_an_unreadable_checkpoint(tmp_path):
    path = _fixture(str(tmp_path), 4, seed=15, epochs=2, checkpoint_interval=1)
    _, trainer = _trainer(path)
    trainer.train()
    ckpts = os.path.join(str(tmp_path), "fixture", "model_checkpoints")
    with open(os.path.join(ckpts, "epoch_3.pt"), "wb") as f:
        f.write(b"truncated")
    _, t2 = _trainer(path)
    assert t2.resume_candidates() == [os.path.join(ckpts, f"epoch_{e}.pt") for e in (3, 2, 1)]
    t2.resume("auto")
    assert t2.epoch == 2 and t2.loss_history == trainer.loss_history


def test_trainer_trains_the_models_tree(tmp_path):
    rc = load_run_config(_fixture(str(tmp_path), 4, seed=16, epochs=1))
    model = build_model(rc, device="cpu")
    before = [t.clone() for t in tree_leaves(model.params)]
    trainer = Trainer(rc, model, device="cpu")
    assert model.params is trainer.params
    trainer.train()
    assert any(not torch.equal(a, b) for a, b in zip(before, tree_leaves(model.params)))


def test_layout_detection_model(tmp_path):
    """``build_model``'s object: seeded weights, ``predict`` and ``loss``
    through the detector's functions, and a checkpoint round trip into a
    model built from another seed."""
    from layoutdit_tpu_torch.models.detection.detector import (
        detector_predict,
        draw_priorities,
    )

    rc = load_run_config(_fixture(str(tmp_path), 2, seed=17, epochs=1))
    model = build_model(rc, seed=0, device="cpu")
    assert model.num_params() == sum(t.numel() for t in tree_leaves(model.params))
    same = build_model(rc, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(model.params),
                                                  tree_leaves(same.params)))
    images = torch.rand((2, 3, IMAGE_SIZE, IMAGE_SIZE), generator=torch.Generator().manual_seed(0))
    dets = model.predict(images)
    want = detector_predict(model.params, images, model.cfg)
    assert torch.equal(dets.boxes, want.boxes) and torch.equal(dets.scores, want.scores)
    gt_boxes = torch.tensor([[[4.0, 4.0, 40.0, 30.0]], [[10.0, 20.0, 60.0, 50.0]]])
    losses = model.loss(images, gt_boxes, torch.tensor([[1], [3]]), torch.ones(2, 1, dtype=bool),
                        draw_priorities(model.cfg, 2, 1, torch.Generator().manual_seed(0)))
    assert sorted(losses) == ["loss_box_reg", "loss_classifier", "loss_objectness",
                              "loss_rpn_box_reg"]
    assert all(torch.isfinite(v) for v in losses.values())

    path = model.save_checkpoint(str(tmp_path), "run", 3, extra={"note": 1})
    assert path == f"{tmp_path}/run/model_checkpoints/epoch_3.pt"
    other = build_model(rc, seed=1, device="cpu")
    state = other.restore_checkpoint(path)
    assert state["epoch"] == 3 and state["extra"] == {"note": 1}
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(other.params),
                                                  tree_leaves(model.params)))


# ------------------------------------------------------------------ main


@pytest.fixture
def final_metrics():
    """The dicts ``main`` logs as "Final metrics", one per run."""
    records = []

    class Handler(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("Final metrics"):
                records.append(record.args)

    handler = Handler()
    root = logging.getLogger("layoutdit_tpu_torch")
    root.addHandler(handler)
    yield records
    root.removeHandler(handler)


def test_main_trains_scores_and_visualizes(tmp_path, monkeypatch, final_metrics):
    root = str(tmp_path)
    path = _fixture(root, 8, seed=1, epochs=2, eval_interval=1, checkpoint_interval=1)
    monkeypatch.setenv("LAYOUTDIT_CONFIG", path)
    run = os.path.join(root, "fixture")
    predictions = os.path.join(run, "predictions.json")

    # --skip-train scores the freshly built model
    port_main.main(["--device", "cpu", "--skip-train"])
    with open(predictions) as f:
        untrained = json.load(f)
    rc = load_run_config(path)
    fresh = Evaluator(build_model(rc, seed=rc.train.seed, device="cpu"), rc, device="cpu")
    assert final_metrics[-1] == fresh.score()
    assert not os.path.exists(os.path.join(run, "model_checkpoints"))

    port_main.main(["--device", "cpu"])
    with open(predictions) as f:
        trained = json.load(f)
    assert trained and trained != untrained
    metrics = final_metrics[-1]
    assert set(COCO_KEYS) <= set(metrics)
    assert all(-1 <= metrics[k] <= 1 for k in metrics)
    # the last epoch's mid-eval scored the same weights as the final eval:
    # main evaluates the trained tree
    with open(os.path.join(run, "metrics", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["epoch"] for r in recs] == [1, 2]
    assert recs[-1]["mAP"] == metrics["mAP"]
    for name in ("epoch_1.pt", "epoch_2.pt", "best.pt"):
        assert os.path.exists(os.path.join(run, "model_checkpoints", name))
    for kind in ("preds", "gt"):
        assert sorted(os.listdir(os.path.join(run, f"visualizations_{kind}"))) == [
            f"{i}.jpg" for i in range(1, 9)]


def test_main_resume_auto(tmp_path, monkeypatch):
    root = str(tmp_path)
    path = _fixture(root, 4, seed=2, epochs=1, checkpoint_interval=1)
    monkeypatch.setenv("LAYOUTDIT_CONFIG", path)
    metrics_file = os.path.join(root, "fixture", "metrics", "metrics.jsonl")
    # an empty run dir: a fresh start
    port_main.main(["--device", "cpu", "--resume", "auto", "--skip-eval"])
    with open(metrics_file) as f:
        first = [json.loads(line) for line in f]
    assert [r["epoch"] for r in first] == [1]

    # a populated run dir: the run goes on from epoch_1.pt
    with open(path) as f:
        raw = json.load(f)
    raw["train_config"]["num_epochs"] = 2
    with open(path, "w") as f:
        json.dump(raw, f)
    port_main.main(["--device", "cpu", "--resume", "auto", "--skip-eval"])
    with open(metrics_file) as f:
        recs = [json.loads(line) for line in f]
    assert [r["epoch"] for r in recs] == [1, 2] and recs[0] == first[0]
    state = load_checkpoint(os.path.join(root, "fixture", "model_checkpoints", "epoch_2.pt"),
                            map_location="cpu")
    assert state["epoch"] == 2 and state["extra"]["updates"] == 2


def test_main_refuses_what_the_port_lacks(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("LAYOUTDIT_CONFIG", _fixture(str(tmp_path), 4, seed=3, epochs=1))
    with pytest.raises(SystemExit):
        port_main.main(["--device", "cpu", "--read_config"])
    assert "LAYOUTDIT_CONFIG" in capsys.readouterr().err
    # LAYOUTDIT_DIT_BASE_PTH is no longer refused: the tiny fixture's
    # encoder is not dit-base's, so the model starts from random weights
    # (JAX's behaviour) and the file is never read
    pth = tmp_path / "dit-base.pth"
    pth.write_bytes(b"not a checkpoint")
    monkeypatch.setenv("LAYOUTDIT_DIT_BASE_PTH", str(pth))
    port_main.main(["--device", "cpu", "--skip-train", "--skip-eval"])


# ---------------------------------------------------------------- config


def test_eval_config_fields_load_with_jax_defaults():
    jax_defaults = JaxEvalConfig()
    for name, value in vars(EvalConfig()).items():
        assert getattr(jax_defaults, name) == value, name
    rc = run_config_from_dict({
        "eval_config": {"eval_input": "val", "eval_base_path": "/x", "score_thresh": 0.3,
                        "max_per_image": 4, "visualize_dirpath_prefix": "vis",
                        "num_images": None, "per_category_metrics": False,
                        "segm_metrics": True, "device": "auto"},
        "train_config": {"eval_interval": 2, "early_stop_patience": 3},
    })
    assert rc.eval == EvalConfig(score_thresh=0.3, max_per_image=4,
                                 visualize_dirpath_prefix="vis", num_images=None,
                                 per_category_metrics=False)
    assert (rc.eval_input, rc.eval_base_path) == ("val", "/x")
    assert rc.eval_split() == ("gs://layoutdit/data/val/", "gs://layoutdit/data/val.json")
    assert (rc.train.eval_interval, rc.train.early_stop_patience) == (2, 3)


@pytest.mark.parametrize("section,key,value,match", [
    ("train_config", "enable_profile", True, "profile_train"),
    ("eval_config", "device", "cpu", "CUDA card"),
    ("train_config", "trace_log_dir", "/tmp/traces", "profile_train"),
    ("precision", "param_dtype", "bfloat16", "fp32 parameters"),
    ("train_config", "device", "cpu", "CUDA card"),
])
def test_waiting_fields_are_refused(section, key, value, match):
    if key != "device":
        # the trainer's profiler and param_dtype are ported: they load
        rc = run_config_from_dict({section: {key: value}})
        assert (rc.param_dtype if section == "precision" else getattr(rc.train, key)) == value
        return
    with pytest.raises(ValueError, match=f"{key}.*{match}"):
        run_config_from_dict({section: {key: value}})


def test_lora_config_is_refused_naming_its_item():
    """``configs/lora.json`` loads now (LoRA is ported), as do the
    fields that waited with it: ``backbone_type: resnet50``,
    ``previous_layout_dit_checkpoint`` and ``lora_freeze_base``."""
    path = os.path.join(os.path.dirname(__file__), os.pardir, "configs", "lora.json")
    rc = load_run_config(path)
    assert (rc.model.lora_rank, rc.model.lora_alpha, rc.model.lora_targets) == (
        16, 16.0, ("q", "v"))
    rc = run_config_from_dict({"detection_model_config": {
        "lora_rank": 0, "lora_alpha": 16.0, "lora_targets": ["q", "v"]}})
    assert rc.model == run_config_from_dict({}).model
    rc = run_config_from_dict({
        "detection_model_config": {"backbone_type": "resnet50",
                                   "previous_layout_dit_checkpoint": "dit.pth"},
        "train_config": {"lora_freeze_base": False}})
    assert (rc.model.backbone_type, rc.model.previous_layout_dit_checkpoint,
            rc.train.lora_freeze_base) == ("resnet50", "dit.pth", False)


def test_get_run_config(tmp_path, monkeypatch):
    monkeypatch.delenv("LAYOUTDIT_CONFIG", raising=False)
    assert get_run_config() == run_config_from_dict({})
    path = _fixture(str(tmp_path), 2, seed=4, epochs=3)
    monkeypatch.setenv("LAYOUTDIT_CONFIG", path)
    assert get_run_config() == load_run_config(path)
    monkeypatch.setenv("LAYOUTDIT_CONFIG", str(tmp_path / "missing.json"))
    with pytest.raises(FileNotFoundError):
        get_run_config()
