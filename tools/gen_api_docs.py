"""Generate docs/API.md from the package's public surface.

Deterministic introspection: every name exported by ``neilpy_tpu``
(the reference-parity API, SURVEY.md §2) plus the public helpers of
each submodule, grouped by module, with the signature and the first
docstring paragraph.  Run ``python tools/gen_api_docs.py`` after
changing any public docstring; tests/test_examples.py asserts the
committed file is current.
"""

from __future__ import annotations

import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

# module -> one-line role, in layer order (SURVEY.md §1)
MODULES = [
    ("neilpy_tpu", "top-level reference-parity API (all 74 reference "
                   "exports plus the framework's own extensions)"),
    ("neilpy_tpu.core.grid", "grid/point primitives"),
    ("neilpy_tpu.core.affine", "affine transforms and worldfile math"),
    ("neilpy_tpu.core.shift", "the `ashift` edge-replicating shift and "
                              "direction tables"),
    ("neilpy_tpu.core.codes", "terrain-code/base-3 utilities and "
                              "progressive windows"),
    ("neilpy_tpu.io.geotiff", "own GeoTIFF reader/writer (imread / "
                              "imwrite)"),
    ("neilpy_tpu.io.las", "LAS 1.0-1.4 reader and 1.2/1.4 writer"),
    ("neilpy_tpu.io.worldfile", "ESRI worldfile read/write"),
    ("neilpy_tpu.io.png", "paletted PNG write"),
    ("neilpy_tpu.io.text", "ISPRS text point-cloud loader"),
    ("neilpy_tpu.ops.surface", "slope/aspect/curvature/hillshade "
                               "stencils"),
    ("neilpy_tpu.ops.visibility", "openness / skyview / geomorphons"),
    ("neilpy_tpu.ops.pallas_scan", "Pallas ladder kernel (GPU "
                                   "fast path, Triton)"),
    ("neilpy_tpu.backend", "platform -> engine / interpret / cache "
                           "choices"),
    ("neilpy_tpu.ops.pointgrid", "point-to-raster gridding "
                                 "(create_dem)"),
    ("neilpy_tpu.ops.inpaint", "springs/FDA inpainting (multigrid CG)"),
    ("neilpy_tpu.ops.morphology", "grey disk morphology (SMRF ladder)"),
    ("neilpy_tpu.ops.spline", "bicubic spline sampling"),
    ("neilpy_tpu.ops.stats", "raster statistics (Gi*, Moran, scoring)"),
    ("neilpy_tpu.pipelines.smrf", "the SMRF ground-filter pipeline"),
    ("neilpy_tpu.pipelines.mosaic", "out-of-core fused terrain-product "
                                    "mosaics"),
    ("neilpy_tpu.dist.halo", "mesh + halo-exchange primitives"),
    ("neilpy_tpu.dist.api", "sharded op wrappers (sharded_geomorphons "
                            "et al.)"),
    ("neilpy_tpu.dist.smrf", "sharded SMRF raster phase"),
    ("neilpy_tpu.dist.tiling", "tiled streaming, apply_parallel, "
                               "checkpoint/resume"),
    ("neilpy_tpu.viz.shading", "swiss/colortable/brassel/pssm "
                               "cartography"),
    ("neilpy_tpu.geo.proj", "projection engine (coord_transform)"),
    ("neilpy_tpu.photo.gnss", "GNSS/RTK track utilities"),
    ("neilpy_tpu.photo.exif", "EXIF geotagging and PPK pipeline"),
    ("neilpy_tpu.filters", "pedagogical per-pixel filter parity specs"),
    ("neilpy_tpu.utils", "misc utilities (voxelize, print options)"),
    ("neilpy_tpu.profiling", "throughput counters and device tracing"),
]

OUT = os.path.join(os.path.dirname(__file__), "..", "docs", "API.md")


def _first_paragraph(doc):
    if not doc:
        return "(undocumented)"
    doc = inspect.cleandoc(doc)
    para = doc.split("\n\n")[0].strip()
    return " ".join(para.split())


def _signature(obj):
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def _public_names(mod):
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [n for n in sorted(dir(mod))
            if not n.startswith("_")
            and getattr(getattr(mod, n), "__module__", None)
            == mod.__name__]


def generate():
    lines = [
        "# neilpy_tpu API reference",
        "",
        "Generated by `python tools/gen_api_docs.py` — do not edit by "
        "hand.",
        "Parity citations (`reference neilpy.py:<line>`) live in the "
        "full docstrings;",
        "this file is the one-paragraph map of the public surface.",
        "",
    ]
    top = importlib.import_module("neilpy_tpu")
    top_names = [n for n in sorted(dir(top))
                 if not n.startswith("_")
                 and not inspect.ismodule(getattr(top, n))]
    lines.append(f"## `neilpy_tpu` — {MODULES[0][1]}")
    lines.append("")
    lines.append(f"{len(top_names)} public names, importable directly "
                 "(`import neilpy_tpu as nt`).  Details under each "
                 "defining module below.")
    lines.append("")
    lines.append("| name | defined in |")
    lines.append("|---|---|")
    for n in top_names:
        obj = getattr(top, n)
        where = getattr(obj, "__module__", "") or ""
        lines.append(f"| `{n}` | `{where}` |")
    lines.append("")
    for modname, role in MODULES[1:]:
        mod = importlib.import_module(modname)
        names = _public_names(mod)
        if not names:
            continue
        lines.append(f"## `{modname}` — {role}")
        lines.append("")
        for n in names:
            obj = getattr(mod, n, None)
            if obj is None:
                continue
            if inspect.ismodule(obj):
                continue
            if inspect.isclass(obj):
                head = f"### `{n}` (class)"
            elif callable(obj):
                head = f"### `{n}{_signature(obj)}`"
            else:
                head = f"### `{n}` (constant, {type(obj).__name__})"
            lines.append(head)
            lines.append("")
            lines.append(_first_paragraph(inspect.getdoc(obj)))
            lines.append("")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    text = generate()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        f.write(text)
    print(f"wrote {os.path.normpath(OUT)} "
          f"({text.count(chr(10))} lines)")
