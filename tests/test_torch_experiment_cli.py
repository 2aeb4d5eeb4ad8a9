"""The port's experiment tooling (``ddti_tpu_torch/cli``: params,
split_config, sweep, aggregate, split_data, prepare, preview) against the
JAX package's tools on the CPU, on the same inputs and seeds: files and
printed tables compared exactly (bytes, lines), the sweep's job control
with the JAX tests' preemption cases, a two-entry config sweep through the
port's training CLI, and ``fold_batchnorm`` refusing LegacyUNet.

The preview grids are drawn by different renderers (matplotlib in JAX,
Pillow in the port): their sizes and layouts are compared exactly, and the
port's column 0, the un-augmented originals, pixel for pixel against JAX's
frames and contours rendered through the same panel code.
"""

import csv
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from ddti_tpu.cli import aggregate as jaggregate
from ddti_tpu.cli import params as jparams
from ddti_tpu.cli import prepare as jprepare
from ddti_tpu.cli import split_config as jsplit_config
from ddti_tpu.cli import split_data as jsplit_data
from ddti_tpu.data import generate_ddti_like as jgenerate
from ddti_tpu.eval.contours import find_contours as jfind_contours
from ddti_tpu_torch.cli import aggregate, params, prepare, preview
from ddti_tpu_torch.cli import split_config, split_data, sweep
from ddti_tpu_torch.eval import visualize
from ddti_tpu_torch.models import create_model
from ddti_tpu_torch.train.fold_bn import fold_batchnorm
from ddti_tpu_torch.utils.weight_init import init_like_flax

from test_prepare import _square, _write_raw_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY = sys.executable


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: xdist runs six of these processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_params_prints_jax_lines(capsys):
    """``cli/params.py`` line for line as JAX's prints it: the reference
    set (legacy zoo) and the active zoo, 14 counts."""
    assert params.main([]) == 0
    got = capsys.readouterr().out.splitlines()
    assert jparams.main([]) == 0
    want = capsys.readouterr().out.splitlines()
    assert got == want
    assert len([l for l in got if ": " in l]) == 14
    assert "ImprovedVNet: 160435681" in got


def test_split_config_writes_jax_bytes(tmp_path, capsys):
    """The repository's 70-entry matrix split by both tools: the same
    files, byte for byte, and the same counts."""
    matrix = os.path.join(ROOT, "configs", "config.yaml")
    got = split_config.split_config(matrix, str(tmp_path / "port"))
    want = jsplit_config.split_config(matrix, str(tmp_path / "jax"))
    assert got == want and sum(got.values()) == 70
    a, b = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert a == b and len(a) == 70
    assert split_config.main([]) == 1
    assert "ddti_tpu_torch.cli.split_config" in capsys.readouterr().out


def _stamp_job(log, i, secs=0.3, rc=0):
    """A job that logs its start and end times and exits ``rc``."""
    return [PY, "-c",
            f"import time, sys; t = time.time(); time.sleep({secs}); "
            f"open({str(log)!r}, 'a').write(f'{i} {{t}} {{time.time()}}\\n')"
            f"; sys.exit({rc})"]


def test_run_jobs_caps_concurrency_and_keeps_order(tmp_path, monkeypatch):
    """Six jobs at most two at a time: return codes in input order, never
    more than two running at once, launches at least ``min_gap`` apart.
    The launch times are taken where the runner launches (a job's own
    clock starts after its interpreter's start-up, which a loaded host
    stretches unevenly)."""
    launched = []

    class Recorded(subprocess.Popen):
        def __init__(self, *args, **kwargs):
            launched.append(time.time())
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(sweep.subprocess, "Popen", Recorded)
    log = tmp_path / "log"
    codes = sweep.run_jobs([_stamp_job(log, i, rc=i % 3) for i in range(6)],
                           max_jobs=2, min_gap=0.05)
    assert codes == [0, 1, 2, 0, 1, 2]
    spans = sorted(tuple(map(float, l.split()[1:]))
                   for l in log.read_text().splitlines())
    assert len(spans) == 6
    for t, _ in spans:
        assert sum(s <= t < e for s, e in spans) <= 2
    assert len(launched) == 6
    assert all(b - a >= 0.04 for a, b in zip(launched, launched[1:]))


def test_run_jobs_retries_failed_jobs(tmp_path):
    """A job that fails on its first launch is launched again by
    ``retries``; a shell-string job runs through the shell."""
    counter = tmp_path / "count"
    flaky = [PY, "-c",
             f"import os, sys; p = {str(counter)!r}; "
             f"c = int(open(p).read()) if os.path.exists(p) else 0; "
             f"open(p, 'w').write(str(c + 1)); sys.exit(0 if c else 3)"]
    out = tmp_path / "shell.txt"
    codes = sweep.run_jobs([flaky, f"echo hi > {out}"], max_jobs=2,
                           min_gap=0, retries=1)
    assert codes == [0, 0]
    assert counter.read_text() == "2" and out.read_text() == "hi\n"
    counter.unlink()
    assert sweep.run_jobs([flaky], max_jobs=1, min_gap=0) == [3]


# the JAX tests' fake preempted job (tests/test_preempt.py): exits 75 after
# writing its hint unless it was relaunched with --resume CKPT
_FAKE_JOB = """
import json, os, sys
if "--resume" in sys.argv:
    i = sys.argv.index("--checkpoint_path")
    assert sys.argv[i + 1] == "CKPT", sys.argv
    sys.exit(0)
with open(os.environ["DDTI_RESUME_HINT"], "w") as f:
    json.dump({"checkpoint_path": "CKPT", "epochs": 7}, f)
sys.exit(75)
"""


def _counting_job(tmp_path, finish_after=None):
    """A job counting its launches in ``count``, preempted (exit 75 with a
    hint) on each launch but, with ``finish_after``, from that launch on;
    a launch without ``--resume`` appends to ``scratch``."""
    counter, scratch = tmp_path / "count", tmp_path / "scratch"
    done = (f"if c + 1 >= {finish_after}:\n    sys.exit(0)\n"
            if finish_after else "")
    job = tmp_path / "job.py"
    job.write_text(
        "import json, os, sys\n"
        f"c = int(open({str(counter)!r}).read()) if "
        f"os.path.exists({str(counter)!r}) else 0\n"
        f"open({str(counter)!r}, 'w').write(str(c + 1))\n"
        "if '--resume' not in sys.argv:\n"
        f"    open({str(scratch)!r}, 'a').write('x')\n"
        + done +
        "with open(os.environ['DDTI_RESUME_HINT'], 'w') as f:\n"
        "    json.dump({'checkpoint_path': 'CKPT'}, f)\n"
        "sys.exit(75)\n")
    return [PY, str(job)], counter, scratch


@pytest.mark.parametrize("case", ["resume", "no_hint", "cap", "retry_pass",
                                  "compound"])
def test_sweep_side_preemption_matches_jax(tmp_path, case, capsys):
    """JAX's sweep-side preemption cases (tests/test_preempt.py): a job
    that exits 75 after writing its hint is relaunched with --resume
    --checkpoint_path <hint> and succeeds; exit 75 without a hint is a
    failure; a job preempted on every launch stops after max_resumes
    relaunches; the retries pass relaunches a still-preempted job WITH the
    resume flags, never from scratch; a compound shell line is left at
    exit 75."""
    if case == "resume":
        job = tmp_path / "job.py"
        job.write_text(_FAKE_JOB)
        assert sweep.run_jobs([[PY, str(job)], [PY, "-c", "pass"]],
                              max_jobs=2, min_gap=0) == [0, 0]
        assert "job 0 preempted" in capsys.readouterr().out
    elif case == "no_hint":
        assert sweep.run_jobs([[PY, "-c", "import sys; sys.exit(75)"]],
                              max_jobs=1, min_gap=0) == [75]
    elif case == "cap":
        cmd, counter, _ = _counting_job(tmp_path)
        assert sweep.run_jobs([cmd], max_jobs=1, min_gap=0,
                              max_resumes=2) == [75]
        assert int(counter.read_text()) == 3  # 1 launch + 2 resumes
    elif case == "retry_pass":
        cmd, counter, scratch = _counting_job(tmp_path, finish_after=3)
        assert sweep.run_jobs([cmd], max_jobs=1, min_gap=0, max_resumes=1,
                              retries=1) == [0]
        assert int(counter.read_text()) == 3  # launch, resume, retry-resume
        assert scratch.read_text() == "x"  # only the first was scratch
    else:
        job = tmp_path / "job.py"
        job.write_text(_FAKE_JOB)
        line = f"{PY} {job} > {tmp_path / 'out.txt'}"
        assert sweep._with_resume(line, "CKPT") is None
        assert sweep._with_resume("python x.py", "a b") \
            == "python x.py --resume --checkpoint_path 'a b'"
        assert sweep.run_jobs([line], max_jobs=1, min_gap=0) == [75]
        assert "left at exit 75" in capsys.readouterr().out


def test_sweep_main_needs_work(capsys):
    assert sweep.main([]) == 1
    assert "nothing to run" in capsys.readouterr().out


TINY = {"MoresVNet2D": dict(in_channels=1, out_channels=1,
                            features=[4, 8]),
        "MoresTransUNet": dict(in_channels=1, out_channels=1,
                               features=[4, 8], trans_dim=16, num_heads=2,
                               num_layers=1, image_size=32)}


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """run.sh's path at a tiny size: a two-entry matrix split by the
    port's split_config and swept by its sweep through
    ``ddti_tpu_torch.cli.main --device cpu`` (1 epoch, 32^2), two jobs at
    a time. Returns (sweep rc, experiments dir, stdout)."""
    d = tmp_path_factory.mktemp("sweep")
    matrix = d / "matrix.yaml"
    matrix.write_text(yaml.safe_dump(
        [{"model": {"model_type": m, "kwargs": kw}}
         for m, kw in TINY.items()]))
    split_config.split_config(str(matrix), str(d / "cfg"))
    exp = d / "exp"
    rc = sweep.main([
        "--config_dir", str(d / "cfg"), "--max_jobs", "2", "--min_gap", "0",
        "--extra", ("--device cpu --mode both --synthetic --epochs 1 "
                    "--image_size 32 --store_size 32 --batch_size 16 "
                    f"--log_every 0 --base_dir {exp}")])
    return rc, exp


def test_config_dir_sweep_end_to_end(swept):
    """Both sweep jobs trained and tested through the port's CLI: one run
    tree per entry with its model's best .pth and .npz and test
    metrics."""
    rc, exp = swept
    assert rc == 0
    runs = sorted(os.listdir(exp))
    assert [r.split("_")[0] for r in runs] == sorted(TINY)
    for r in runs:
        model = r.split("_")[0]
        assert os.path.exists(exp / r / "models" / f"{model}_best.pth")
        assert os.path.exists(exp / r / "models" / f"{model}_best.npz")
        with open(exp / r / "result" / "test_metrics.json") as f:
            assert 0.0 <= json.load(f)["iou"] <= 1.0
        snap = yaml.safe_load((exp / r / "config.yaml").read_text())
        assert snap["model_kwargs"] == TINY[model]


def _fake_tree(root):
    """Three runs: metrics from result/test_metrics.json, from the log's
    last Test Metrics block (two blocks), and none (skipped)."""
    a = root / "ResUNet_20260101_000000"
    (a / "result").mkdir(parents=True)
    (a / "result" / "test_metrics.json").write_text(json.dumps(
        {"iou": 0.61234, "f1": 0.7, "precision": 0.8, "recall": 0.75,
         "acc": 0.9, "hd95_mean": 12.5, "assd_mean": 3.25,
         "threshold": 0.45, "total_images": 16, "tta": True}))
    (a / "config.yaml").write_text(yaml.safe_dump(
        {"model_type": "ResUNet", "image_size": 256, "batch_size": 16,
         "lr": 1e-4, "use_elastic": True,
         "model_kwargs": {"base_filters": 64, "depth": 5}}))
    b = root / "MoresUNet_20260101_000001"
    (b / "log").mkdir(parents=True)
    block = ("Test Metrics\n  ACC={:.4f}, Precision=0.5000, Recall=0.6000, "
             "F1=0.5500, IoU={:.4f}\n")
    (b / "log" / "train_log.log").write_text(block.format(0.8, 0.2)
                                             + block.format(0.85, 0.7))
    (root / "Empty_20260101_000002" / "log").mkdir(parents=True)


@pytest.mark.parametrize("sort", ["iou", "hd95_mean"])
def test_aggregate_table_and_csv_equal_jax(tmp_path, capsys, swept, sort):
    """Over a tree of made-up runs (JSON metrics, the log fallback, a run
    without metrics) and over the sweep's real run tree: the printed table
    and the CSV are JAX's, line for line and byte for byte."""
    fake = tmp_path / "fake"
    _fake_tree(fake)
    for tree in (fake, swept[1]):
        out = {}
        for name, tool in (("port", aggregate), ("jax", jaggregate)):
            csv_path = tmp_path / f"{name}_{tree.name}.csv"
            assert tool.main(["--experiments_dir", str(tree), "--output",
                              str(csv_path), "--sort", sort]) == 0
            text = capsys.readouterr().out.replace(str(csv_path), "CSV")
            out[name] = (text, csv_path.read_bytes())
        assert out["port"] == out["jax"]
        rows = list(csv.DictReader(out["port"][1].decode().splitlines()))
        assert len(rows) == 2
    assert rows[0]["iou"] != "" and rows[0]["model_type"] in TINY
    assert aggregate.main(["--experiments_dir", str(tmp_path / "no")]) == 1


def _flat_dump(d, n=11):
    d.mkdir()
    for i in range(n):
        Image.new("L", (8, 8), i).save(d / f"img{i:02d}.jpg")
        Image.new("L", (8, 8), 255).save(d / f"img{i:02d}_mask.png")
    Image.new("L", (8, 8), 0).save(d / "lonely.jpg")


@pytest.mark.parametrize("flags", [[], ["--ratios", "0.6,0.2,0.2"],
                                   ["--kfold", "4", "--fold", "3"],
                                   ["--seed", "7", "--copy"]])
def test_split_data_manifest_and_tree_equal_jax(tmp_path, flags, capsys):
    """The same manifest (seed, ratios or fold, name lists) and the same
    tree (names; symlink targets or copied bytes) as JAX's for a seed."""
    src = tmp_path / "flat"
    _flat_dump(src)
    trees = {}
    for name, tool in (("port", split_data), ("jax", jsplit_data)):
        out = tmp_path / name
        assert tool.main(["--source", str(src), "--output", str(out),
                          *flags]) == 0
        trees[name] = out
    assert "1 unpaired" in capsys.readouterr().out
    man = [json.loads((trees[n] / "split_manifest.json").read_text())
           for n in ("port", "jax")]
    assert man[0] == man[1]
    assert sum(len(v) for v in man[0]["splits"].values()) == 11
    listed = {n: sorted(os.path.relpath(os.path.join(d, f), trees[n])
                        for d, _, files in os.walk(trees[n]) for f in files)
              for n in trees}
    assert listed["port"] == listed["jax"] and len(listed["jax"]) == 23
    for rel in listed["jax"]:
        a, b = trees["port"] / rel, trees["jax"] / rel
        assert os.path.islink(a) == os.path.islink(b)
        if os.path.islink(b):
            assert os.readlink(a) == os.readlink(b)
        else:
            assert a.read_bytes() == b.read_bytes()


def test_split_tree_loads_in_the_port(tmp_path):
    """The tree split_data writes loads in the port's dataset reader."""
    from ddti_tpu_torch.data.dataset import MedicalDataset

    src = tmp_path / "flat"
    _flat_dump(src)
    assert split_data.main(["--source", str(src), "--output",
                            str(tmp_path / "t")]) == 0
    ds = MedicalDataset(str(tmp_path / "t" / "train"),
                        str(tmp_path / "t" / "train_mask"))
    assert len(ds) == 8


@pytest.mark.parametrize("fmt, keep_empty", [("jpg", False), ("png", True)])
def test_prepare_masks_bit_equal_to_jax(tmp_path, fmt, keep_empty):
    """The synthetic DDTI cases of tests/test_prepare.py (two frames a
    case, squares, two polygons on a frame, an empty mark, a malformed
    one): the port writes the same masks, byte for byte, the same image
    links and the same manifest as JAX's; the dump pairs up for
    split_data and loads in the port's dataset reader."""
    src = tmp_path / "raw"
    src.mkdir()
    _write_raw_case(str(src), "1")
    _write_raw_case(str(src), "2", svg2=json.dumps(
        [_square(0, 0, 12, 9), _square(20, 18, 40, 44)]))
    _write_raw_case(str(src), "3", size=(50, 40),
                    svg1=json.dumps([_square(5, 5, 25, 35)]),
                    svg2="not json")
    outs = {}
    for name, tool in (("port", prepare), ("jax", jprepare)):
        outs[name] = tmp_path / name
        man = tool.prepare(str(src), str(outs[name]), fmt, keep_empty)
        outs[name + "_man"] = man
    assert outs["port_man"] == outs["jax_man"]
    a, b = _files(outs["port"]), _files(outs["jax"])
    assert sorted(a) == sorted(b)
    masks = [k for k in a if "_mask." in k]
    assert len(masks) == (6 if keep_empty else 4)
    for k in masks:
        assert a[k] == b[k], k
    pairs, unpaired = split_data.find_pairs(str(outs["port"]))
    assert len(pairs) == len(masks) and not unpaired
    from ddti_tpu_torch.data.dataset import MedicalDataset

    tree = tmp_path / "tree"
    assert split_data.main(["--source", str(outs["port"]), "--output",
                            str(tree), "--ratios", "1,0,0"]) == 0
    assert len(MedicalDataset(str(tree / "train"),
                              str(tree / "train_mask"))) == len(masks)


PREVIEW = ["--synthetic", "--count", "2", "--variants", "2", "--store_size",
           "48", "--image_size", "40", "--seed", "5", "--use_speckle",
           "true", "--p_crop", "0.5"]


def test_preview_grid_layout_and_column_0_match_jax(tmp_path, capsys,
                                                    monkeypatch):
    """The port's grid (Pillow) has JAX's size and layout (matplotlib's
    2.2-inch panels at 110 dpi: 242 pixels, rows x (1 + variants)); its
    column 0 equals, pixel for pixel, JAX's synthetic frames and JAX's
    contours drawn by the same panel code; each draw column holds red
    contour pixels and differs from column 0."""
    port_png, jax_png = tmp_path / "p.png", tmp_path / "j.png"
    assert preview.main([*PREVIEW, "--device", "cpu", "--output",
                         str(port_png)]) == 0
    assert "wrote 2x3 preview grid (use_speckle, p_crop" \
        in capsys.readouterr().out
    from ddti_tpu.cli import preview as jpreview

    assert jpreview.main([*PREVIEW, "--cpu", "--output", str(jax_png)]) == 0
    assert "wrote 2x3 preview grid" in capsys.readouterr().out
    got = np.asarray(Image.open(port_png).convert("RGB"))
    assert got.shape[:2] == Image.open(jax_png).size[::-1] == (2 * 242,
                                                              3 * 242)

    images, masks = jgenerate(2, (48, 48), 5)
    monkeypatch.setattr(visualize, "find_contours", jfind_contours)
    want = preview.draw_grid(images, masks, [], str(tmp_path / "w.png"))
    assert want == (2, 1)
    col0 = np.asarray(Image.open(tmp_path / "w.png").convert("RGB"))
    np.testing.assert_array_equal(got[:, :242], col0)
    assert np.any(np.all(col0 == (0, 0, 255), -1))
    for c in (1, 2):
        panel = got[:, c * 242:(c + 1) * 242]
        assert np.any(np.all(panel == (255, 0, 0), -1))
        assert not np.array_equal(panel, got[:, :242])


def test_fold_batchnorm_refuses_legacy_unet():
    """LegacyUNet's Conv -> ReLU -> BN blocks: folding through the ReLU is
    invalid, and ``fold_batchnorm`` raises rather than return a misfolded
    model (JAX ``fold_bn.py``'s numerical check)."""
    m = init_like_flax(create_model("LegacyUNet"), 0).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # scales of both signs, as JAX's test draws
        for name, t in m.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif name.endswith(("running_mean", "bias")):
                t.copy_(torch.randn(t.shape, generator=g) * 0.2)
            elif t.dim() == 1:  # a BatchNorm's scale
                t.copy_(torch.randn(t.shape, generator=g))
    with pytest.raises(ValueError, match="cannot be folded"):
        fold_batchnorm(m, "LegacyUNet")
