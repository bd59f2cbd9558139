"""The port's native COCO parser (``layoutdit_tpu_torch/native``): the
cases of ``tests/test_coco_native.py`` through the port, and the port's
arrays against the JAX package's ``parse_coco_bytes`` on the same
bytes, hostile inputs included (both must return None on each of them).
The port builds its library under ``build/native/``, never beside the
source. The JAX package's library is built for this module alone, in a
directory of its own (``jax_native``): its own build writes straight to
the file it then opens beside its source, so a test process that opens
it while another process is still writing it would load nothing."""

import importlib.util
import json
import os

import numpy as np
import pytest

from layoutdit_tpu.native import cocojson as jax_coco
from layoutdit_tpu_torch.data.dataset import PubLayNetDataset
from layoutdit_tpu_torch.eval.coco_eval import CocoEvaluator
from layoutdit_tpu_torch.native import cocojson

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("img_id", "img_w", "img_h", "ann_id", "ann_img", "ann_cat", "ann_crowd", "ann_bbox",
          "ann_area")


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's parser, built by its own ``_build`` into a
    directory that belongs to this module, never at the shared path
    beside its source, and loaded; its module state is put back after the
    module. Fails, rather than comparing None with None, if it does not
    build."""
    so = str(tmp_path_factory.mktemp("jax_native_coco") / os.path.basename(jax_coco._so_path()))
    saved = (jax_coco._lib, jax_coco._build_failed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_coco, "_so_path", lambda: so)
        jax_coco._lib, jax_coco._build_failed = None, False
        try:
            assert jax_coco._load() is not None, \
                f"the JAX package's COCO parser did not build at {so}"
            yield jax_coco
        finally:
            jax_coco._lib, jax_coco._build_failed = saved


@pytest.fixture(scope="module")
def native(jax_native):
    """The port's parser, built here (g++ is on this machine), beside the
    JAX package's (``jax_native``)."""
    if not cocojson.available():
        pytest.skip("the native COCO parser did not build (no g++)")
    return cocojson


def _coco_json(n_img=7, n_ann=23, seed=0, **extras):
    rng = np.random.default_rng(seed)
    data = {
        "info": {"year": 2020, "description": "synthetic é中"},
        "licenses": [{"id": 1, "url": "http://x"}],
        "images": [
            {"id": 100 + i, "width": int(rng.integers(100, 2000)),
             "height": int(rng.integers(100, 2000)), "file_name": f"dir/PMC_{i:04d}ü.jpg",
             "license": 1}
            for i in range(n_img)
        ],
        "annotations": [
            {"id": j, "image_id": 100 + int(rng.integers(0, n_img)),
             "category_id": int(rng.integers(1, 6)),
             "bbox": [round(float(v), 2) for v in rng.uniform(0, 500, 4)],
             "area": round(float(rng.uniform(1, 1e5)), 3), "iscrowd": int(rng.integers(0, 2)),
             "segmentation": [[float(v) for v in rng.uniform(0, 500, 8)]]}
            for j in range(n_ann)
        ],
        "categories": [{"id": c, "name": n, "supercategory": ""}
                       for c, n in enumerate(["text", "title", "list", "table", "figure"], 1)],
    }
    data.update(extras)
    return data


def _same_as_jax(raw: bytes):
    """The port's arrays of ``raw``, asserted equal to the JAX parser's
    (None on both sides, or every field bit for bit)."""
    assert jax_coco._lib is not None, "the JAX package's COCO parser is not loaded"
    got, want = cocojson.parse_coco_bytes(raw), jax_coco.parse_coco_bytes(raw)
    assert (got is None) == (want is None)
    if want is None:
        return None
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.file_names == want.file_names and got.categories == want.categories
    return got


def test_differential_vs_python_json_and_jax(native):
    data = _coco_json()
    raw = json.dumps(data).encode()
    arr = _same_as_jax(raw)
    assert arr is not None
    re = arr.to_coco_data()
    py = json.loads(raw.decode())
    assert [im["id"] for im in re["images"]] == [im["id"] for im in py["images"]]
    for a, b in zip(re["images"], py["images"]):
        assert (a["width"], a["height"], a["file_name"]) == (b["width"], b["height"],
                                                             b["file_name"])
    assert len(re["annotations"]) == len(py["annotations"])
    for a, b in zip(re["annotations"], py["annotations"]):
        for k in ("id", "image_id", "category_id", "iscrowd"):
            assert a[k] == b[k]
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=1e-6)
        assert abs(a["area"] - b["area"]) < 1e-6 * max(1.0, b["area"])
    assert re["categories"] == py["categories"]


@pytest.mark.parametrize("kwargs", [{"separators": (",", ":")}, {"ensure_ascii": True},
                                    {"indent": 3}])
def test_escapes_and_compact_whitespace(native, kwargs):
    data = _coco_json(n_img=2, n_ann=1)
    data["images"][0]["file_name"] = 'we\\ird\t"name"\n♞.jpg'
    arr = _same_as_jax(json.dumps(data, **kwargs).encode())
    assert arr is not None and arr.file_names[0] == data["images"][0]["file_name"]


def test_key_order_independent(native):
    data = _coco_json(n_img=1, n_ann=1)
    img, ann = data["images"][0], data["annotations"][0]
    data["images"][0] = dict(reversed(list(img.items())))
    data["annotations"][0] = dict(reversed(list(ann.items())))
    arr = _same_as_jax(json.dumps(data).encode())
    assert arr is not None and arr.img_id[0] == img["id"]
    np.testing.assert_allclose(arr.ann_bbox[0], ann["bbox"], rtol=1e-6)


def _bad_variants() -> list[str]:
    ok = _coco_json(n_img=1, n_ann=1)
    out = []
    for mutate in (lambda d: d["images"][0].pop("file_name"),
                   lambda d: d["annotations"][0].pop("bbox"),
                   lambda d: d["annotations"][0].update(image_id="str-id"),
                   lambda d: d.pop("categories")):
        d = json.loads(json.dumps(ok))
        mutate(d)
        out.append(json.dumps(d))
    text = json.dumps(ok)
    out += [text[:-20], text + "garbage", '{"images": [1, 2]}', "[]", "",
            text.replace('"id": 100,', '"id": 100.0,'),  # a float id
            text.replace(f'"width": {ok["images"][0]["width"]}', '"width": 612.5')]
    return out


@pytest.mark.parametrize("case", range(len(_bad_variants())))
def test_strict_failures_return_none_on_both_sides(native, case):
    raw = _bad_variants()[case].encode()
    assert cocojson.parse_coco_bytes(raw) is None, raw[:80]
    assert _same_as_jax(raw) is None


def test_empty_sections_ok(native):
    arr = _same_as_jax(json.dumps({"images": [], "annotations": [], "categories": []}).encode())
    assert arr is not None and len(arr.img_id) == 0 and len(arr.ann_id) == 0
    assert arr.categories == []


def test_hostile_corpus_matches_jax(native, tmp_path):
    """Every file of the sanitizer test's hostile corpus (truncations, byte
    flips, garbage, deep nesting, escape bombs, a lone surrogate): the
    port's parser agrees with the JAX package's, None included."""
    spec = importlib.util.spec_from_file_location(
        "jax_sanitizers", os.path.join(REPO, "tests", "test_sanitizers.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    paths = mod._corpus_coco(str(tmp_path))
    parsed = 0
    for path in paths:
        with open(path, "rb") as f:
            parsed += _same_as_jax(f.read()) is not None
    assert len(paths) > 50 and parsed >= 1


def test_dataset_native_matches_fallback(native, tmp_path, monkeypatch):
    """``PubLayNetDataset`` on the native path equals the ``json.loads``
    path: ids, labels, image info, targets bit for bit, the lazy
    ``coco_data`` and ``annotations`` views."""
    data = _coco_json(n_img=5, n_ann=17, seed=4)
    data["annotations"][0]["bbox"] = [10.0, 10.0, 0.0, 5.0]  # degenerate: dropped
    ann_path = str(tmp_path / "ann.json")
    with open(ann_path, "w") as f:
        json.dump(data, f)
    ds_native = PubLayNetDataset(str(tmp_path), ann_path)
    assert ds_native.native
    monkeypatch.setenv("LAYOUTDIT_NO_NATIVE_COCO", "1")
    ds_py = PubLayNetDataset(str(tmp_path), ann_path)
    assert not ds_py.native
    assert ds_native.ids == ds_py.ids and ds_native.cat_id_to_label == ds_py.cat_id_to_label
    for i in ds_py.ids:
        for k in ("id", "width", "height", "file_name"):
            assert ds_native.image_info[i][k] == ds_py.image_info[i][k]
        ta, tb = ds_native.load_target(i), ds_py.load_target(i)
        for k in ("boxes", "labels", "image_id"):
            assert ta[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(ta[k], tb[k])
    cd_n, cd_p = ds_native.coco_data, ds_py.coco_data
    assert cd_n["categories"] == cd_p["categories"]
    assert len(cd_n["annotations"]) == len(cd_p["annotations"])
    for a, b in zip(cd_n["annotations"], cd_p["annotations"]):
        for k in ("id", "image_id", "category_id", "iscrowd", "area", "bbox"):
            assert a[k] == b[k], k
    assert set(ds_native.annotations) == set(ds_py.annotations)
    for i, anns in ds_py.annotations.items():
        assert [a["id"] for a in ds_native.annotations[i]] == [a["id"] for a in anns]


def test_dataset_targets_match_jax_dataset(native, tmp_path):
    """The port's native-path targets equal the JAX dataset's, whose own
    native parser reads the same file."""
    from layoutdit_tpu.data.dataset import PubLayNetDataset as JaxDataset

    data = _coco_json(n_img=6, n_ann=30, seed=5)
    ann_path = str(tmp_path / "ann.json")
    with open(ann_path, "w") as f:
        json.dump(data, f)
    mine, theirs = PubLayNetDataset(str(tmp_path), ann_path), JaxDataset(str(tmp_path), ann_path)
    assert mine.native and theirs._arr is not None and mine.ids == theirs.ids
    for i in mine.ids:
        a, b = mine.load_target(i), theirs.load_target(i)
        for k in ("boxes", "labels", "image_id"):
            np.testing.assert_array_equal(a[k], b[k])


def test_evaluator_same_metrics_native(native, tmp_path, monkeypatch):
    data = _coco_json(n_img=4, n_ann=12, seed=9)
    ann_path = str(tmp_path / "ann.json")
    with open(ann_path, "w") as f:
        json.dump(data, f)
    preds = [{"image_id": int(a["image_id"]), "category_id": int(a["category_id"]),
              "bbox": list(a["bbox"]), "score": 0.9 - 0.01 * k}
             for k, a in enumerate(data["annotations"][:8])]
    ds_native = PubLayNetDataset(str(tmp_path), ann_path)
    monkeypatch.setenv("LAYOUTDIT_NO_NATIVE_COCO", "1")
    ds_py = PubLayNetDataset(str(tmp_path), ann_path)
    assert CocoEvaluator(ds_native.coco_data).evaluate(preds) == \
        CocoEvaluator(ds_py.coco_data).evaluate(preds)


def test_built_under_build_native_and_opt_out_skips_it(native, monkeypatch):
    so = cocojson.library_path()
    assert so.exists() and so.parent == cocojson.BUILD_DIR
    assert so.parent.parts[-2:] == ("build", "native")
    src_dir = cocojson.SRC.parent
    assert not [n for n in os.listdir(src_dir) if n.endswith(".so")]
    # the source is the JAX package's, byte for byte
    with open(os.path.join(REPO, "layoutdit_tpu", "native", "coco_parse.cc"), "rb") as f:
        assert f.read() == cocojson.SRC.read_bytes()
    monkeypatch.setenv("LAYOUTDIT_NO_NATIVE_COCO", "1")
    assert not cocojson.available()
