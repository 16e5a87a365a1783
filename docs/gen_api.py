"""Generate docs/api.md from the live module docstrings.

Mirrors the reference's sphinx autodoc tree (docs/source/api.rst) without
the sphinx dependency: every public method of nvstrings / nvcategory /
numeric_category / nvtext is listed with its signature and first doc
paragraph.  Run:  python docs/gen_api.py
"""

import inspect
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")


def first_para(doc):
    if not doc:
        return "(undocumented)"
    return " ".join(inspect.cleandoc(doc).split("\n\n")[0].split())


def emit_class(out, cls, title):
    out.append(f"## {title}\n")
    if cls.__doc__:
        out.append(first_para(cls.__doc__) + "\n")
    for name in sorted(dir(cls)):
        if name.startswith("_"):
            continue
        fn = getattr(cls, name)
        if not callable(fn):
            continue
        try:
            sig = str(inspect.signature(fn)).replace("self, ", "").replace(
                "(self)", "()"
            )
        except (TypeError, ValueError):
            sig = "(...)"
        out.append(f"### `{name}{sig}`\n")
        out.append(first_para(fn.__doc__) + "\n")


def emit_module_fns(out, mod, title, names=None):
    out.append(f"## {title}\n")
    for name in sorted(dir(mod)):
        if name.startswith("_"):
            continue
        fn = getattr(mod, name)
        if not inspect.isfunction(fn) or fn.__module__ != mod.__name__:
            continue
        if names is not None and name not in names:
            continue
        try:
            sig = str(inspect.signature(fn))
        except (TypeError, ValueError):
            sig = "(...)"
        out.append(f"### `{name}{sig}`\n")
        out.append(first_para(fn.__doc__) + "\n")


def main():
    from custrings import nvstrings as nvs_mod
    from custrings import nvcategory as nvc_mod
    from custrings import nvtext as nvt_mod

    out = [
        "# API reference\n",
        "Generated from the live docstrings by `docs/gen_api.py` — the",
        "same surface as the reference's sphinx tree",
        "(`/root/reference/docs/source/api.rst`): `nvstrings`,",
        "`nvcategory` (incl. `numeric_category`), `nvtext`.\n",
    ]
    emit_class(out, nvs_mod.nvstrings, "nvstrings (class)")
    emit_module_fns(
        out,
        nvs_mod,
        "nvstrings (module constructors)",
        names={
            "to_device", "from_strings", "from_offsets", "from_csv",
            "itos", "ltos", "ftos", "dtos", "int2ip", "ip2int",
            "from_booleans", "int2timestamp", "create_from_ipc",
            "free", "bind_cpointer",
        },
    )
    emit_class(out, nvc_mod.nvcategory, "nvcategory (class)")
    if hasattr(nvc_mod, "numeric_category"):
        emit_class(out, nvc_mod.numeric_category, "numeric_category (class)")
    emit_module_fns(out, nvc_mod, "nvcategory (module constructors)")
    emit_module_fns(out, nvt_mod, "nvtext (module)")

    path = os.path.join(os.path.dirname(__file__), "api.md")
    with open(path, "w") as f:
        f.write("\n".join(out))
    print(f"wrote {path} ({len(out)} blocks)")


if __name__ == "__main__":
    main()
