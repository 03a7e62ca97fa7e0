"""Registry documentation generator (the docs pipeline).

Reference parity: the UDF doc-extraction pipeline
(``src/carnot/docstring/`` + ``udf_exporter``) that turns
registered-function metadata into published reference docs. Here the
registry is the single source: every scalar/UDA/UDTF overload renders
into one markdown document.
"""

from __future__ import annotations


def _sig(arg_types, ret, semantic: int = 1) -> str:
    from ..types.semantic import SemanticType

    args = ", ".join(t.name for t in arg_types)
    sig = f"({args}) -> {ret.name}"
    if semantic not in (0, 1):  # UNSPECIFIED / NONE render nothing
        try:
            sig += f" [{SemanticType(semantic).name}]"
        except ValueError:
            sig += f" [semantic={semantic}]"  # user-defined value
    return sig


def generate_markdown(registry=None) -> str:
    """Markdown reference for every registered function."""
    from .registry import default_registry

    reg = registry or default_registry()
    lines = ["# pixie_tpu function reference", ""]

    lines += ["## Scalar functions", ""]
    for name in sorted(reg.scalar_names()):
        ovs = reg.scalar_overloads(name)
        doc = next((o.doc for o in ovs if o.doc), "")
        lines.append(f"### `{name}`")
        if doc:
            lines.append(doc)
        lines.append("")
        for o in ovs:
            lines.append(
                f"- `{name}{_sig(o.arg_types, o.return_type, o.semantic_type)}`"
            )
        lines.append("")

    lines += ["## Aggregate functions", ""]
    for name in sorted(reg.uda_names()):
        ovs = reg.uda_overloads(name)
        doc = next((o.doc for o in ovs if o.doc), "")
        lines.append(f"### `{name}`")
        if doc:
            lines.append(doc)
        lines.append("")
        for o in ovs:
            lines.append(
                f"- `{name}{_sig(o.arg_types, o.return_type, o.semantic_type)}`"
            )
        lines.append("")

    udtfs = sorted(reg.udtf_names())
    if udtfs:
        lines += ["## Table-generating functions (UDTF)", ""]
        for name in udtfs:
            d = reg.get_udtf(name)
            lines.append(f"### `{name}`")
            if d.doc:
                lines.append(d.doc)
            lines.append("")
            rel = ", ".join(f"{n}: {t.name}" for n, t in d.relation)
            lines.append(f"- returns `({rel})`")
            if d.init_args:
                args = ", ".join(
                    f"{e[0]}: {e[1].name}"
                    + (f" = {e[2]!r}" if len(e) > 2 else "")
                    for e in d.init_args
                )
                lines.append(f"- init args: `{args}`")
            lines.append("")
    return "\n".join(lines)
