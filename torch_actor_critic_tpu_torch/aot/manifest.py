"""The warm-start manifest, derived from the checked tables (a copy of
the JAX package's ``aot/manifest.py`` over the port's capture sites).

There is no third list of programs to bundle: the set is derived from
``analysis.reachability.ENTRY_POINTS`` (the capture sites the static
analyzer pins against the code) joined with the ``bundleable`` column of
``analysis.contracts.ENTRY_POINT_CONTRACTS`` (an explicit literal on
every row, the ``stale-bundle-manifest`` rule). A new capture site
therefore cannot ship without declaring whether it is bundled, and
:func:`entry_point_table` fails loudly on any divergence between the two
tables.

Bundled programs are the serving plane's bucket ladder: one per
``(bucket, deterministic)`` pair, the CUDA graphs
``PolicyEngine.warmup`` captures. The training captures are not
bundled: their shapes follow the run's config, and they ride the shared
kernel-library cache (:mod:`.cache`).
"""

from __future__ import annotations

import typing as t

from torch_actor_critic_tpu_torch.analysis.contracts import ENTRY_POINT_CONTRACTS
from torch_actor_critic_tpu_torch.analysis.reachability import ENTRY_POINTS

__all__ = [
    "ManifestError",
    "ProgramSpec",
    "bundled_entry_points",
    "entry_point_table",
    "program_filename",
    "program_name",
    "serve_programs",
]


class ManifestError(RuntimeError):
    """The checked tables disagree: the manifest cannot be derived."""


class ProgramSpec(t.NamedTuple):
    """One bundled program: the entry point's identity at one
    ``(bucket, deterministic)`` shape."""

    name: str           # e.g. "serve/forward[b4].sampled"
    identity: str       # ENTRY_POINTS key, e.g. "serve/forward"
    bucket: int
    deterministic: bool


def entry_point_table() -> t.Dict[str, bool]:
    """``{identity: bundleable}`` over every checked capture site.

    Raises :class:`ManifestError` unless ``ENTRY_POINTS`` and
    ``ENTRY_POINT_CONTRACTS`` cover exactly the same identities (the
    ``stale-contract`` rule's invariant, checked again at run time)."""
    entry_keys = set(ENTRY_POINTS)
    table_keys = set(ENTRY_POINT_CONTRACTS)
    if entry_keys != table_keys:
        raise ManifestError(
            "ENTRY_POINTS and ENTRY_POINT_CONTRACTS diverge — missing contract rows: "
            f"{sorted(entry_keys - table_keys)}; rows with no entry point: "
            f"{sorted(table_keys - entry_keys)}. Fix analysis/contracts.py (the "
            "stale-contract rule flags this too)."
        )
    return {
        identity: bool(ENTRY_POINT_CONTRACTS[identity].bundleable)
        for identity in sorted(entry_keys)
    }


def bundled_entry_points() -> t.Tuple[str, ...]:
    """The identities whose programs go into the warm-start bundle."""
    return tuple(i for i, bundleable in entry_point_table().items() if bundleable)


def program_name(identity: str, bucket: int, deterministic: bool) -> str:
    """The bundle's program key: the per-bucket watchdog label
    (``serve/forward[b4]``) and which of the pair."""
    mode = "det" if deterministic else "sampled"
    return f"{identity}[b{int(bucket)}].{mode}"


def program_filename(name: str) -> str:
    """File-system-safe name for ``name`` (JAX's transform; the port's
    suffix: a program's signature, not a serialized program)."""
    safe = name.replace("/", "__").replace("[b", "-b").replace("]", "")
    return f"{safe}.sig.json"


def serve_programs(
    buckets: t.Sequence[int],
    deterministic_only: bool = False,
) -> t.List[ProgramSpec]:
    """Every program a serving warm-up captures for the bucket ladder:
    the bundled identities × buckets × (deterministic, sampled), in
    warm-up order."""
    specs: t.List[ProgramSpec] = []
    for identity in bundled_entry_points():
        for bucket in buckets:
            for det in (True,) if deterministic_only else (True, False):
                specs.append(ProgramSpec(
                    name=program_name(identity, bucket, det),
                    identity=identity, bucket=int(bucket), deterministic=det,
                ))
    return specs
