"""The port's docs (``docs/torch_*.md``): every field of the port's
``ServeConfig`` appears in ``docs/torch_serving.md``'s reference (with its
default), and every relative link in the port's docs resolves, anchors
stripped (the rule of ``scripts/check_docs.py``, which checks every page
under ``docs/``)."""
import dataclasses
import pathlib
import re

import pytest

from repro_torch.serving.engine import ServeConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
LINK = re.compile(r"\[[^\]]*\]\(([^)#]+)(?:#[^)]*)?\)")
PAGES = sorted((ROOT / "docs").glob("torch_*.md"))


def test_the_port_has_its_docs():
    assert [p.name for p in PAGES] == ["torch_distributed.md", "torch_kernels.md",
                                       "torch_serving.md"]


@pytest.mark.parametrize("field", [f.name for f in dataclasses.fields(ServeConfig)])
def test_every_serve_config_field_is_documented(field):
    text = (ROOT / "docs" / "torch_serving.md").read_text()
    row = next((ln for ln in text.splitlines() if ln.startswith(f"| `{field}` |")), None)
    assert row is not None, field
    default = next(f.default for f in dataclasses.fields(ServeConfig) if f.name == field)
    assert f"`{default!r}`" in row, (field, default, row)


@pytest.mark.parametrize("page", PAGES, ids=lambda p: p.name)
def test_relative_links_resolve(page):
    targets = [t for t in LINK.findall(page.read_text()) if "://" not in t]
    assert targets, page.name
    for target in targets:
        assert (page.parent / target).exists(), (page.name, target)


def test_kernel_doc_covers_k1_to_k6():
    text = (ROOT / "docs" / "torch_kernels.md").read_text()
    for k in range(1, 7):
        assert f"## K{k} · " in text and f"| K{k} |" in text, k
    for src in ("activations", "lstm_cell", "lstm_seq", "int8_matmul", "flash_attention"):
        assert f"`csrc/{src}.cu`" in text and (ROOT / "src/repro_torch/csrc" / f"{src}.cu").exists()
