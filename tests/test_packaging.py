"""Packaging sanity: the pyproject console scripts must resolve.

Reference analog: the ISLE build system produces two executables,
ISLETrain and ISLEInfer (/root/reference/Makefile:61-66); our
installable equivalents are the `isle-train` / `isle-infer` console
scripts declared in pyproject.toml. No pip install happens here (the
environment is sealed); we verify the declared entry points import and
are callable, which is exactly what a wheel install would wire up.
"""

import importlib
import pathlib
import tomllib

import pytest

pytestmark = pytest.mark.quick

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_console_scripts_resolve():
    meta = tomllib.loads((ROOT / "pyproject.toml").read_text())
    scripts = meta["project"]["scripts"]
    assert set(scripts) == {"isle-train", "isle-infer"}
    for target in scripts.values():
        mod_name, func_name = target.split(":")
        fn = getattr(importlib.import_module(mod_name), func_name)
        assert callable(fn)
        # Entry points must behave like CLIs: bad argv -> usage + rc 1,
        # not a traceback.
        assert fn([]) == 1


def test_package_find_matches_tree():
    meta = tomllib.loads((ROOT / "pyproject.toml").read_text())
    include = meta["tool"]["setuptools"]["packages"]["find"]["include"]
    assert "isle_jax*" in include
    # Every package dir under isle_jax/ must have an __init__.py so
    # setuptools' find_packages actually ships it.
    for d in (ROOT / "isle_jax").rglob("*"):
        if d.is_dir() and d.name != "__pycache__":
            assert (d / "__init__.py").exists(), f"missing __init__.py in {d}"
