"""The port keeps the JAX package's import ladder and codec seam.

``tools/check_layering.py`` holds ``src/repro`` to two rules: module-level
imports point strictly down the layer ladder, and outside ``compression/``
and ``kernels/`` nothing imports the codec's private modules or its
mode-specific free functions.  Its ``check`` and ``_layer_of`` know only
the name ``repro``, so this file reads ``src/repro_torch`` with its own
layer lookup and the tool's AST helpers, under the same rules.
"""
import ast
import importlib
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import check_layering  # noqa: E402

PORT = "repro_torch"
PORT_SRC = os.path.join(REPO, "src", PORT)
SEAM_PRIVATE = tuple(m.replace("repro.", PORT + ".", 1)
                     for m in check_layering.SEAM_PRIVATE_MODULES)


def _layer(module: str):
    """'repro_torch.data.store' -> 'data'; None outside the ladder."""
    parts = module.split(".")
    if parts[0] != PORT or len(parts) < 2:
        return None
    return parts[1] if parts[1] in check_layering.LAYER_RANK else None


def _port_modules():
    for dirpath, _dirs, files in os.walk(PORT_SRC):
        for fname in sorted(files):
            if fname.endswith(".py"):
                path = os.path.join(dirpath, fname)
                rel = os.path.relpath(path, os.path.dirname(PORT_SRC))
                module = rel[:-3].replace(os.sep, ".").removesuffix(".__init__")
                with open(path) as f:
                    yield rel, module, ast.parse(f.read(), filename=rel)


def port_violations(modules=None):
    """Both rules of ``check_layering.check`` over the port's modules."""
    rank = check_layering.LAYER_RANK
    out = []
    for rel, module, tree in (modules if modules is not None else _port_modules()):
        layer = _layer(module)
        for node, module_level in check_layering._module_level_imports(tree):
            targets = check_layering._imported_modules(node)
            if layer not in check_layering.SEAM_EXEMPT_LAYERS:
                out += [f"{rel}:{node.lineno}: imports seam-private {t}"
                        for t in targets if t.startswith(SEAM_PRIVATE)]
                if (isinstance(node, ast.ImportFrom) and node.module
                        and node.module.startswith(PORT + ".compression")):
                    bad = sorted(a.name for a in node.names
                                 if a.name in check_layering.SEAM_PRIVATE_NAMES)
                    if bad:
                        out.append(f"{rel}:{node.lineno}: imports mode-specific "
                                   f"codec function(s) {', '.join(bad)}")
            if not module_level or layer is None:
                continue
            for tgt in targets:
                tl = _layer(tgt)
                if tl is not None and tl != layer and rank[tl] >= rank[layer]:
                    out.append(f"{rel}:{node.lineno}: layer '{layer}' imports "
                               f"layer '{tl}' at module level")
    return out


def test_port_has_no_layering_violations():
    violations = port_violations()
    assert not violations, "\n".join(violations)


def test_scan_reads_every_layer_of_the_port():
    layers = {_layer(m) for _r, m, _t in _port_modules()}
    assert set(check_layering.LAYER_RANK) <= layers


@pytest.mark.parametrize("source, expect", [
    ("from repro_torch.train.optimizer import AdamState\n", "layer 'models' imports layer 'train'"),
    ("def f():\n    from repro_torch.train.optimizer import AdamState\n", None),
    ("from repro_torch.obs import trace\n", None),
    ("from repro_torch.compression.zfp import crop\n", "seam-private"),
    ("def f():\n    from repro_torch.compression import decode_batch\n", "mode-specific"),
])
def test_rules_catch_what_the_tool_catches(source, expect):
    """A module-level upward import and a seam bypass (lazy or not) are
    reported; a lazy upward import and a downward one are not."""
    found = port_violations([("repro_torch/models/x.py", "repro_torch.models.x",
                              ast.parse(source))])
    if expect is None:
        assert not found
    else:
        assert len(found) == 1 and expect in found[0]


def test_core_has_no_module_level_train_or_serving_imports():
    offenders = []
    for rel, module, tree in _port_modules():
        if _layer(module) != "core":
            continue
        for node, module_level in check_layering._module_level_imports(tree):
            offenders += [f"{rel}:{node.lineno}: {t}"
                          for t in check_layering._imported_modules(node)
                          if module_level and t.startswith((PORT + ".train",
                                                            PORT + ".serving"))]
    assert not offenders, offenders


def test_core_and_models_import_without_train():
    """Importing the port's core and models packages leaves the train and
    serving stacks out of ``sys.modules``."""
    saved = {k: v for k, v in sys.modules.items() if k.startswith(PORT)}
    for k in saved:
        del sys.modules[k]
    try:
        for name in ("repro_torch.core.ensemble", "repro_torch.core",
                     "repro_torch.models.surrogate", "repro_torch.models.lm"):
            importlib.import_module(name)
        loaded = [m for m in sys.modules
                  if m.startswith((PORT + ".train", PORT + ".serving"))]
        assert not loaded, loaded
    finally:
        for k in [k for k in sys.modules if k.startswith(PORT)]:
            del sys.modules[k]
        sys.modules.update(saved)


# the modules that run a seed ensemble's stacked members: each runs them
# through models/folded.py, none maps the single model over the member axis
FOLDED_CALLERS = ("core/ensemble.py", "train/source.py", "serving/surrogate_engine.py")


def _vmap_calls(tree):
    """Lines of ``tree``'s calls of ``vmap``, as ``torch.func.vmap``, or
    imported by name."""
    return sorted(n.lineno for n in ast.walk(tree) if isinstance(n, ast.Call)
                  and (n.func.attr if isinstance(n.func, ast.Attribute)
                       else getattr(n.func, "id", None)) == "vmap")


@pytest.mark.parametrize("rel", FOLDED_CALLERS)
def test_stacked_members_run_folded_not_vmapped(rel):
    assert _vmap_calls(ast.parse("torch.func.vmap(f)(x)\nvmap(g)\n")) == [1, 2]
    with open(os.path.join(PORT_SRC, rel)) as f:
        calls = _vmap_calls(ast.parse(f.read(), filename=rel))
    assert not calls, f"{rel} calls vmap on lines {calls}"
