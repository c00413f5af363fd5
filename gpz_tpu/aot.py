"""AOT executable cache: skip trace+lower for known training programs.

A fresh process pays, per training phase, the jax trace+lower of the
training while_loop even when the persistent compilation cache already
holds the compiled executable (unavoidable through the jit path), plus the
executable read itself. This module caches the COMPILED
executable (jax.experimental.serialize_executable) keyed by everything
that determines the program — config, argument shapes/dtypes, statics,
jax version, backend — so a repeat process calls the loaded executable
directly, paying neither trace nor lowering nor cache lookup.

Scope: the pickled executable is a local, same-machine, same-jax-version
cache (the key includes both), NOT a distribution format. Any load/run
failure falls back silently to the normal jit path. Opt out with
GPZ_AOT=0. The files live in `aot/` under gpz_tpu.cache_dir()
(JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache).
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Callable, Optional

import jax

def _dir() -> str:
    from gpz_tpu import cache_dir

    return os.path.join(cache_dir(), "aot")


#: in-process handle cache: deserialize once per process
_LOADED: dict = {}

import threading as _threading

_LOCK = _threading.Lock()
_INFLIGHT: dict = {}  # key -> Event set when a load attempt finished


def enabled() -> bool:
    return os.environ.get("GPZ_AOT") != "0"


_FINGERPRINT = None


def code_fingerprint() -> str:
    """Hash of the sources that determine the traced training programs —
    part of every cache key, so editing the objective/optimizer can never
    serve a stale executable (no manual version bump to forget)."""
    global _FINGERPRINT
    if _FINGERPRINT is None:
        import gpz_tpu.linalg
        import gpz_tpu.model
        import gpz_tpu.objective
        import gpz_tpu.ops.ozaki
        import gpz_tpu.optim.lbfgs
        import gpz_tpu.phi

        h = hashlib.sha256()
        for mod in (gpz_tpu.objective, gpz_tpu.phi, gpz_tpu.linalg,
                    gpz_tpu.ops.ozaki, gpz_tpu.optim.lbfgs, gpz_tpu.model):
            try:
                with open(mod.__file__, "rb") as fh:
                    h.update(fh.read())
            except OSError:
                h.update(mod.__name__.encode())
        _FINGERPRINT = h.hexdigest()[:16]
    return _FINGERPRINT


def _abstract_sig(tree) -> str:
    leaves = jax.tree.leaves(tree)
    return ";".join(
        f"{getattr(a, 'shape', None)}:{getattr(a, 'dtype', type(a).__name__)}"
        for a in leaves
    )


def cache_key(semantic_key: str, args_tree, statics: tuple) -> str:
    """Filesystem key for one compiled program.

    `semantic_key` must capture everything that determines the traced
    computation but is not visible in the argument avals — for the
    training loop that is the phase ModelConfig, completeness flags, and
    a code-version tag bumped when optimizer/objective tracing changes.
    """
    payload = "|".join([
        semantic_key,
        code_fingerprint(),
        _abstract_sig(args_tree),
        repr(statics),
        jax.__version__,
        jax.default_backend(),
    ])
    return hashlib.sha256(payload.encode()).hexdigest()[:32]


def load(key: str):
    """The deserialized Compiled for `key`, or None.

    Concurrency-safe: a load already in flight on another thread (the
    prefetcher) is waited on instead of duplicated — deserializing the big
    training programs takes seconds."""
    if not enabled():
        return None
    while True:
        with _LOCK:
            if key in _LOADED:
                return _LOADED[key]
            ev = _INFLIGHT.get(key)
            if ev is None:
                ev = _threading.Event()
                _INFLIGHT[key] = ev
                break
        ev.wait()
        with _LOCK:
            done = key in _LOADED
        if done:
            return _LOADED[key]
        return None  # the other attempt failed; caller rebuilds

    try:
        path = os.path.join(_dir(), key + ".jaxexe")
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as fh:
                serialized, in_tree, out_tree = pickle.load(fh)
        except Exception:  # corrupt file: unreadable by anyone — drop it
            try:
                os.remove(path)
            except OSError:
                pass
            return None
        try:
            from jax.experimental.serialize_executable import (
                deserialize_and_load,
            )

            compiled = deserialize_and_load(serialized, in_tree, out_tree)
        except Exception:
            # the BACKEND refused it (version skew, or a prefetch racing a
            # different backend's entry) — the file may still be valid for
            # the backend that wrote it, so keep it; the caller rebuilds
            return None
        with _LOCK:
            _LOADED[key] = compiled
        return compiled
    finally:
        with _LOCK:
            _INFLIGHT.pop(key, None)
        ev.set()


def _manifest_path() -> str:
    return os.path.join(_dir(), "manifest.json")


def _read_manifest() -> dict:
    """Manifest as {group: {key: {"backend": b, "fp": fingerprint|None}}}.
    Migrates older formats (v1 flat {group: [keys]}, v2 {group: {key:
    backend}}) with backend guessed as current / fp unknown — the only
    cost of a wrong guess is one failed (non-destructive) prefetch."""
    import json

    path = _manifest_path()
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as fh:
            raw = json.load(fh)
    except Exception:
        return {}
    be = jax.default_backend()
    out = {}
    for group, entry in raw.items():
        if isinstance(entry, list):  # v1
            out[group] = {k: {"backend": be, "fp": None} for k in entry}
        elif isinstance(entry, dict):
            out[group] = {
                k: (v if isinstance(v, dict) else {"backend": v, "fp": None})
                for k, v in entry.items()
            }
    return out


def note_group(group: str, key: str) -> None:
    """Record that `key` was used by the logical task `group` on the
    current backend, so a later process can prefetch the whole group's
    executables up front."""
    if not enabled():
        return
    import json

    try:
        os.makedirs(_dir(), exist_ok=True)
        entry = {"backend": jax.default_backend(), "fp": code_fingerprint()}
        with _LOCK:
            manifest = _read_manifest()
            keys = manifest.setdefault(group, {})
            if keys.get(key) != entry:
                keys[key] = entry
                path = _manifest_path()
                tmp = path + ".tmp"
                with open(tmp, "w") as fh:
                    json.dump(manifest, fh)
                os.replace(tmp, path)
    except Exception:
        pass


def _spawn_loads(keys) -> None:
    """One daemon thread per key: a SERIAL prefetch of the phase-1 and
    refine-phase executables can finish after phase 1 has already run dry,
    leaving the refine phase waiting on its executable behind the phase-1
    load. The in-flight dedup in load() keeps concurrent callers from
    duplicating work."""

    def work(k):
        try:
            load(k)
        except Exception:
            pass

    for k in keys:
        _threading.Thread(target=work, args=(k,), daemon=True).start()


def prefetch_group(group: str) -> None:
    """Start loading every executable previously recorded for `group` (on
    this backend) in parallel daemon threads. Hides the later phases'
    executable deserialization under the earlier phases' execution."""
    if not enabled():
        return
    try:
        entry = _read_manifest().get(group, {})
        keys = [k for k, v in entry.items() if _loadable(v)]
    except Exception:
        return
    _spawn_loads(keys)


def _loadable(meta: dict) -> bool:
    """Skip prefetching executables another backend wrote or that a since-
    edited code version produced (their exact keys can never be requested
    again — the fingerprint is part of the key — but the dead files would
    otherwise be unpickled speculatively by every prefetch, and the dead
    TRAINING executables run to hundreds of MB)."""
    if meta.get("backend") != jax.default_backend():
        return False
    fp = meta.get("fp")
    return fp is None or fp == code_fingerprint()


def prefetch_all() -> None:
    """Start loading EVERY executable the manifest records for the current
    backend, in parallel. Hook for task entry points (gpz_tpu.init): a
    fresh process that is about to train cannot know the exact group key
    yet (it depends on train()-time config edits and budgets), but the
    executables it will want are almost surely among the machine's recent
    ones — and an executable load that is already in flight when
    minimize() asks for it is pure saved latency (the phase-1 load is
    otherwise unhideable: it gates the first optimizer step). Loads that
    turn out unneeded only cost background host time. Opt out with
    GPZ_AOT_PREFETCH=0."""
    if not enabled() or os.environ.get("GPZ_AOT_PREFETCH") == "0":
        return
    try:
        manifest = _read_manifest()
        keys = {
            k
            for entry in manifest.values()
            for k, v in entry.items()
            if _loadable(v)
        }
    except Exception:
        return
    _spawn_loads(keys)


def save(key: str, compiled) -> None:
    if not enabled():
        return
    try:
        from jax.experimental.serialize_executable import serialize

        payload = serialize(compiled)
        os.makedirs(_dir(), exist_ok=True)
        tmp = os.path.join(_dir(), key + ".tmp")
        with open(tmp, "wb") as fh:
            pickle.dump(payload, fh)
        os.replace(tmp, os.path.join(_dir(), key + ".jaxexe"))
        _LOADED[key] = compiled
    except Exception:  # serialization unsupported on this backend
        pass


def call_or_build(
    key: Optional[str],
    jitted: Callable,
    build_args: tuple,
    call_args: tuple,
    static_argnums_done: bool = True,
) -> Any:
    """Run `jitted(*build_args)` through the AOT cache.

    `build_args` are the full arguments (including statics) used for
    lower(); `call_args` the dynamic-only arguments the Compiled expects.
    Returns the outputs; falls back to the plain jit call on any miss
    that cannot be built (or when key is None).
    """
    dbg = os.environ.get("GPZ_AOT_DEBUG") == "1"
    if key is None or not enabled():
        return jitted(*build_args)
    import time as _time

    t0 = _time.perf_counter()
    compiled = load(key)
    if dbg:
        print(f"[aot] load({key[:8]}) -> {compiled is not None} "
              f"in {_time.perf_counter() - t0:.2f}s", flush=True)
    if compiled is None:
        try:
            t0 = _time.perf_counter()
            compiled = jitted.lower(*build_args).compile()
            if dbg:
                print(f"[aot] build({key[:8]}) in "
                      f"{_time.perf_counter() - t0:.2f}s", flush=True)
            save(key, compiled)
        except Exception as e:
            if dbg:
                print(f"[aot] build failed ({key[:8]}): {e!r}", flush=True)
            return jitted(*build_args)
    try:
        return compiled(*call_args)
    except Exception as e:
        if dbg:
            print(f"[aot] compiled call failed ({key[:8]}): {e!r}",
                  flush=True)
        return jitted(*build_args)
