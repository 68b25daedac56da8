"""scripts/torch_leiden_fidelity.py against the JAX package's
scripts/leiden_fidelity.py, and the port's container and workflow
(deploy/Dockerfile.torch, deploy/infercnv_tpu_torch.wdl), on the CPU.

The fidelity scripts run at 300 and 1,000 cells.  The reference script's
PCA embedding is handed to the port's (the two packages' range-finder
draws differ, and at 1,000 cells a draw handed across still leaves kNN
near-ties that float rounding decides), so both scripts build the same kNN
and SNN graphs; each script's partition must pass the CPM assertions, and
the port's table must read as the reference's."""

import importlib.util
import json
import re
import shlex
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from infercnv_tpu_torch import cli, native
from infercnv_tpu_torch.ops import _build

from torch_port_util import one_thread_a_pool

ROOT = Path(__file__).resolve().parents[1]
#: the module (the package's __init__ binds the name `leiden` to its function)
jleiden = importlib.import_module("infercnv_tpu.subcluster.leiden")
jpca = importlib.import_module("infercnv_tpu.subcluster.pca")
SIZES = "300,1000"


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread_a_pool():
        yield


def _recording(graphs, fn):
    def f(nn, n, *a, **k):
        A = fn(nn, n, *a, **k)
        graphs.append(A)
        return A
    return f


def test_fidelity_matches_the_reference_script(monkeypatch, capsys):
    ref, port = _script("leiden_fidelity"), _script("torch_leiden_fidelity")
    graphs = {"jax": [], "port": []}
    monkeypatch.setattr(jleiden, "snn_graph", _recording(graphs["jax"], jleiden.snn_graph))
    monkeypatch.setattr(port, "snn_graph", _recording(graphs["port"], port.snn_graph))
    embeddings = []

    def record(x, *a, **k):
        emb = jpca_embed(x, *a, **k)
        embeddings.append(np.array(emb))
        return emb

    def replay(x, *a, device=None, **k):
        return torch.from_numpy(embeddings.pop(0)).to(device)

    jpca_embed = jpca.pca_embed
    monkeypatch.setattr(jpca, "pca_embed", record)
    monkeypatch.setattr(port, "pca_embed", replay)

    monkeypatch.setattr(sys, "argv", ["leiden_fidelity.py", "--sizes", SIZES])
    ref.main()                    # asserts the CPM inequalities itself
    jrows = [line.split() for line in capsys.readouterr().out.splitlines()[1:]]
    assert port.main(["--sizes", SIZES, "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = json.loads(out[-1])["sizes"]
    assert json.loads(out[-1])["device"] == "cpu"

    assert [r["n"] for r in rows] == [int(s) for s in SIZES.split(",")] and not embeddings
    for A, B in zip(graphs["jax"], graphs["port"], strict=True):
        assert A.shape == B.shape and (A != B).nnz == 0
    for r, j in zip(rows, jrows, strict=True):
        assert port.passed(r)
        assert int(j[0]) == r["n"]
        np.testing.assert_allclose(float(j[1]), r["gamma"], rtol=1e-3)
        assert (int(j[2]), int(j[3]), j[4]) == (r["snn_components"], r["leiden_clusters"],
                                                str(r["pure"]))
        for col, key in ((5, "cpm_leiden"), (6, "cpm_components"), (7, "cpm_planted")):
            assert abs(float(j[col]) - r[key]) <= 0.051, (key, j[col], r[key])


def test_fidelity_fails_when_the_cpm_assertion_does():
    port = _script("torch_leiden_fidelity")
    row = dict(cpm_leiden=1.0, cpm_components=2.0, cpm_planted=0.5)
    assert not port.passed(row)
    assert port.passed(dict(row, cpm_components=1.0))


def _wdl_command(text: str) -> str:
    body = re.search(r"command <<<(.*?)>>>", text, re.S).group(1)
    return body.split("\n    tar ")[0]


def test_wdl_calls_the_port_cli_with_flags_its_parser_accepts():
    text = (ROOT / "deploy" / "infercnv_tpu_torch.wdl").read_text()
    # each input by its name; additional_args by its default, ""
    command = _wdl_command(text).replace("\\\n", " ").replace("~{additional_args}", "")
    words = shlex.split(re.sub(r"~\{(\w+)\}", r"\1", command))
    assert words[:3] == ["python3", "-m", "infercnv_tpu_torch.cli"]
    args = cli.build_parser().parse_args(words[3:])
    assert (args.raw_counts_matrix, args.annotations_file, args.gene_order_file,
            args.ref_group_names, args.out_dir, args.device) == (
        "raw_counts_matrix", "annotations_file", "gene_order_file", "ref_group_names",
        "out", "cuda")
    runtime = re.search(r"runtime \{(.*?)\}", text, re.S).group(1)
    assert re.search(r"gpuCount:\s*1\b", runtime)
    assert "gpuType:" in runtime and "nvidiaDriverVersion:" in runtime
    assert "infercnv_tpu_torch" in re.search(r"String docker = \"(.*?)\"", text).group(1)


def test_dockerfile_copies_the_port_and_installs_no_jax():
    lines = (ROOT / "deploy" / "Dockerfile.torch").read_text().splitlines()
    code = [ln for ln in lines if not ln.lstrip().startswith("#")]
    text = "\n".join(code).replace("\\\n", " ")
    assert re.match(r"FROM nvidia/cuda:12\.[\d.]+-devel", code[0])
    assert "jax" not in text.lower()
    assert re.search(r"^COPY infercnv_tpu_torch ", text, re.M)
    assert re.search(r"pip3 install .*\btorch\b.*whl/cu12", text)
    for pkg in ("numpy", "scipy", "matplotlib"):
        assert pkg in text
    assert 'ENTRYPOINT ["python3", "-m", "infercnv_tpu_torch.cli"]' in text
    # the image-time build it describes calls the real build functions
    build = "\n".join(ln for ln in lines if "build()" in ln)
    assert "_build.build()" in build and "native.build()" in build
    assert callable(_build.build) and callable(native.build)
