"""Warm-start bundles: what a fresh serving process needs to answer its
first request without a kernel build (the port's counterpart of the JAX
package's ``aot/bundle.py``).

A bundle is a directory next to the checkpoint (``<run>/artifacts/
checkpoints`` -> ``<run>/artifacts/warm_start``):

``MANIFEST.json``
    The format, the environment **fingerprint** (torch and CUDA
    versions, the card's name and compute capability, the device count,
    the mesh shape and the kernel-source digest), the bucket ladder, the
    kernel libraries by source, and one **signature** per ``(bucket,
    deterministic)`` program: the observation leaves' shapes and dtypes
    at the bucket, the engine's parameter buffers (names, shapes,
    dtypes), the precision tier and ``deterministic``.
``programs/*.sig.json``
    Each program's signature again, one file each.
``kernels/``
    The built library of every ``csrc/`` source under this tree's names
    (:func:`~..ops._kernels.lib_name`): what a process without the CUDA
    toolkit loads instead of running ``nvcc``.

No file can carry a captured CUDA graph, so a consumer captures its
graphs at warm-up as always; what the bundle removes is the kernel
builds, and what it guards is that the consumer serves the model the
bundle was built for. A consumer whose sources, flags or headers differ
computes other library names and a different digest, and rejects the
bundle (:class:`BundleMismatchError`, counted on the watchdog as
``bundle_rejected``); it then resolves the same kernels through the
library cache or ``nvcc``, never through the plain versions.
:func:`build_bundle` runs every program once eagerly with the bundled
libraries and captures no graph.
"""

from __future__ import annotations

import json
import logging
import os
import pathlib
import shutil
import typing as t

import numpy as np
import torch

from torch_actor_critic_tpu_torch.ops import _kernels

logger = logging.getLogger(__name__)

__all__ = [
    "BUNDLE_FORMAT",
    "BundleMismatchError",
    "WarmStartBundle",
    "build_bundle",
    "check_fingerprint",
    "default_bundle_dir",
    "emit_bundle",
    "environment_fingerprint",
    "load_bundle",
    "program_signature",
]

BUNDLE_FORMAT = 1

_MANIFEST = "MANIFEST.json"
_PROGRAMS = "programs"
_KERNELS = "kernels"


class BundleMismatchError(RuntimeError):
    """The bundle does not fit this process (fingerprint, libraries or a
    program's signature). Callers count it on the watchdog and resolve
    the kernels through the cache or ``nvcc``."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def _device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def environment_fingerprint(device: str | torch.device | None = None) -> t.Dict[str, t.Any]:
    """What must match between the process that built a bundle and the
    one consuming it on ``device`` (default: the card if there is one).
    The mesh is ``[1, 1]`` until the port shards (ROADMAP item 6)."""
    dev = _device(device)
    cuda = dev.type == "cuda"
    return {
        "format": BUNDLE_FORMAT,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device_name": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "capability": list(torch.cuda.get_device_capability(dev)) if cuda else None,
        "device_count": torch.cuda.device_count(),
        "mesh_shape": [1, 1],
        "kernel_digest": _kernels.source_digest(),
    }


def check_fingerprint(stored: t.Mapping[str, t.Any], device=None) -> None:
    """Raise :class:`BundleMismatchError` naming every field on which
    ``stored`` disagrees with this process's fingerprint."""
    current = environment_fingerprint(device)
    mismatched = [
        f"{key}: bundle={stored.get(key)!r} here={current[key]!r}"
        for key in current if stored.get(key) != current[key]
    ]
    if mismatched:
        raise BundleMismatchError(
            "warm-start bundle fingerprint mismatch — " + "; ".join(mismatched))


def default_bundle_dir(ckpt_dir: str | os.PathLike) -> pathlib.Path:
    """A checkpoint directory's bundle: its ``warm_start/`` sibling."""
    return pathlib.Path(ckpt_dir).absolute().parent / "warm_start"


def _sig(x) -> t.List[t.Any]:
    """JSON-able ``[shape, dtype]`` of a tensor or an array spec."""
    dtype = x.dtype if isinstance(x, torch.Tensor) else np.dtype(x.dtype)
    return [[int(d) for d in x.shape], str(dtype)]


def program_signature(engine, params, bucket: int, deterministic: bool) -> t.Dict[str, t.Any]:
    """The ``(bucket, deterministic)`` program of ``engine`` over the
    prepared ``params``: observation leaves at the bucket, parameter
    buffers by name (a tuple leaf of the int8 tier as ``name.i``), the
    precision tier and ``deterministic``."""
    from torch_actor_critic_tpu_torch.core.types import MultiObservation

    spec = engine.obs_spec
    leaves = [spec.features, spec.frame] if isinstance(spec, MultiObservation) else [spec]
    buffers = {}
    for name, value in sorted(params.items()):
        if isinstance(value, tuple):
            for i, x in enumerate(value):
                if isinstance(x, torch.Tensor):
                    buffers[f"{name}.{i}"] = _sig(x)
        else:
            buffers[name] = _sig(value)
    return {
        "obs": [[[int(bucket), *map(int, s.shape)], str(np.dtype(s.dtype))] for s in leaves],
        "params": buffers,
        "precision": engine.precision,
        "deterministic": bool(deterministic),
    }


class WarmStartBundle:
    """A loaded (not yet checked) bundle directory."""

    def __init__(self, root: pathlib.Path, manifest: t.Dict[str, t.Any]):
        self.root = pathlib.Path(root)
        self.manifest = manifest

    @property
    def kernels_dir(self) -> pathlib.Path:
        return self.root / _KERNELS

    @property
    def fingerprint(self) -> t.Dict[str, t.Any]:
        return dict(self.manifest.get("fingerprint", {}))

    def programs(self) -> t.Dict[str, t.Dict[str, t.Any]]:
        return dict(self.manifest.get("programs", {}))

    def libraries(self) -> t.Dict[str, str]:
        return dict(self.manifest.get("kernels", {}))

    def check(self, device=None) -> None:
        """The environment gate: the fingerprint, then a library under
        this tree's name for every kernel source (a bundle built from
        other sources holds none)."""
        check_fingerprint(self.fingerprint, device)
        drift = [
            f"{source}: bundle={self.libraries().get(source)!r} here={_kernels.lib_name(source)!r}"
            for source in _kernels.sources()
            if self.libraries().get(source) != _kernels.lib_name(source)
            or not (self.kernels_dir / _kernels.lib_name(source)).is_file()
        ]
        if drift:
            raise BundleMismatchError(
                "warm-start bundle kernel libraries do not match this tree's sources — "
                + "; ".join(drift))

    def verify_program(self, name: str, signature: t.Mapping[str, t.Any]) -> None:
        """Raise :class:`BundleMismatchError` unless program ``name`` is
        bundled with exactly ``signature``."""
        entry = self.manifest.get("programs", {}).get(name)
        if entry is None:
            raise BundleMismatchError(
                f"warm-start bundle has no program {name!r} "
                f"(bundled: {sorted(self.manifest.get('programs', {}))})")
        if entry.get("signature") != json.loads(json.dumps(signature)):
            raise BundleMismatchError(
                f"warm-start bundle program {name!r} signature mismatch — "
                f"bundle={entry.get('signature')} here={dict(signature)} "
                "(model, obs-spec, bucket or precision drift since the bundle was built)")

    def arm(self) -> None:
        """Resolve kernel libraries from this bundle first (:func:`~..ops.
        _kernels.arm_bundle`)."""
        _kernels.arm_bundle(self.kernels_dir)

    def disarm(self) -> None:
        """Stop resolving libraries from this bundle if it is the armed one."""
        if _kernels._bundle_dir == self.kernels_dir:
            _kernels.arm_bundle(None)


def load_bundle(bundle_dir: str | os.PathLike) -> WarmStartBundle:
    """Read a bundle's manifest. Raises ``FileNotFoundError`` when there
    is none, :class:`BundleMismatchError` when it is unreadable or of
    another format."""
    root = pathlib.Path(bundle_dir)
    path = root / _MANIFEST
    if not path.is_file():
        raise FileNotFoundError(f"no warm-start bundle at {root} (missing {_MANIFEST})")
    try:
        manifest = json.loads(path.read_text())
    except (OSError, ValueError) as exc:
        raise BundleMismatchError(f"warm-start bundle manifest unreadable: {path} ({exc})") from exc
    fmt = manifest.get("format")
    if fmt != BUNDLE_FORMAT:
        raise BundleMismatchError(
            f"warm-start bundle format {fmt!r} != supported {BUNDLE_FORMAT} — rebuild the "
            "bundle with this tree")
    return WarmStartBundle(root, manifest)


def _write(path: pathlib.Path, text: str) -> None:
    tmp = path.with_name(path.name + f".tmp{os.getpid()}")
    tmp.write_text(text)
    os.replace(tmp, path)


def build_bundle(
    bundle_dir: str | os.PathLike,
    actor_def: torch.nn.Module,
    obs_spec: t.Any,
    params: t.Mapping[str, torch.Tensor],
    max_batch: int = 64,
    buckets: t.Sequence[int] | None = None,
    deterministic_only: bool = False,
    device: str | torch.device | None = None,
) -> WarmStartBundle:
    """Build a warm-start bundle at ``bundle_dir`` for a serving engine
    over ``actor_def``/``obs_spec`` at ``max_batch``.

    Resolves every kernel source's library (cache, else ``nvcc``), runs
    each ``(bucket, deterministic)`` forward of a real
    :class:`~..serve.engine.PolicyEngine` once eagerly (a finite result
    or the build fails), records each program's signature and copies the
    libraries in. Captures no graph; the manifest is written last."""
    from torch_actor_critic_tpu_torch.aot.manifest import (
        entry_point_table,
        program_filename,
        serve_programs,
    )
    from torch_actor_critic_tpu_torch.serve.engine import PolicyEngine

    root = pathlib.Path(bundle_dir)
    (root / _PROGRAMS).mkdir(parents=True, exist_ok=True)
    (root / _KERNELS).mkdir(parents=True, exist_ok=True)
    engine = PolicyEngine(actor_def, obs_spec, max_batch=max_batch, buckets=buckets,
                          device=device)
    libraries = {source: _kernels.library(source) for source in _kernels.sources()}
    prepared = engine.prepare_params(params)
    generator = torch.Generator(device=engine.device).manual_seed(0)
    programs: t.Dict[str, t.Dict[str, t.Any]] = {}
    for spec in serve_programs(engine.buckets, deterministic_only):
        zero_obs = engine.zero_obs(spec.bucket)
        engine.forward_eager(prepared, zero_obs, generator, spec.deterministic)
        signature = program_signature(engine, prepared, spec.bucket, spec.deterministic)
        fname = program_filename(spec.name)
        _write(root / _PROGRAMS / fname, json.dumps(signature, indent=1))
        programs[spec.name] = {
            "file": fname, "identity": spec.identity, "bucket": spec.bucket,
            "deterministic": spec.deterministic, "signature": signature,
        }
    for path in libraries.values():
        dst = root / _KERNELS / path.name
        if path.resolve() != dst.resolve():
            tmp = dst.with_name(dst.name + f".tmp{os.getpid()}")
            shutil.copy2(path, tmp)
            os.replace(tmp, dst)
    manifest = {
        "format": BUNDLE_FORMAT,
        "fingerprint": environment_fingerprint(engine.device),
        "buckets": [int(b) for b in engine.buckets],
        "max_batch": int(engine.max_batch),
        "deterministic_only": bool(deterministic_only),
        "entry_points": entry_point_table(),
        "kernels": {source: path.name for source, path in libraries.items()},
        "programs": programs,
    }
    _write(root / _MANIFEST, json.dumps(manifest, indent=2))
    logger.info("warm-start bundle built: %s (%d programs, %d libraries)",
                root, len(programs), len(libraries))
    return WarmStartBundle(root, manifest)


def emit_bundle(
    ckpt_dir: str | os.PathLike,
    actor_def: torch.nn.Module,
    obs_spec: t.Any,
    params: t.Mapping[str, torch.Tensor],
    **kwargs: t.Any,
) -> WarmStartBundle:
    """Build the bundle at its checkpoint-adjacent default location
    (``train --emit-bundle true``)."""
    return build_bundle(default_bundle_dir(ckpt_dir), actor_def, obs_spec, params, **kwargs)
