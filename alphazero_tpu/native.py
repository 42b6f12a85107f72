"""ctypes bindings for the native runtime components.

The reference's runtime is native end to end (a Rust crate); here the device
compute path is JAX/XLA and the native layer covers what stays on the
host: the example store (csrc/example_store.cpp — the bincode history
persistence of coach.rs:159-167 rebuilt) and the sequential MCTS oracle
(csrc/mcts_oracle.cpp — the node.rs/async_mcts.rs search semantics,
used to golden-test the vectorized engine).

Libraries are compiled on demand with g++ (no pybind11 in this image; the
C ABI + ctypes keeps the binding dependency-free) and cached next to the
sources. Every entry point degrades gracefully: ``available()`` is False
when no toolchain exists, and Python fallbacks keep the framework usable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_CSRC = os.path.join(os.path.dirname(__file__), "csrc")
_BUILD = os.path.join(_CSRC, "build")
_LIBS = {}


def _build_lib(name: str, source: str) -> Optional[str]:
    os.makedirs(_BUILD, exist_ok=True)
    so_path = os.path.join(_BUILD, f"lib{name}.so")
    src_path = os.path.join(_CSRC, source)
    if os.path.exists(so_path) and os.path.getmtime(so_path) >= os.path.getmtime(src_path):
        return so_path
    try:
        subprocess.run(
            [
                "g++", "-O2", "-std=c++17", "-fPIC", "-shared",
                "-o", so_path, src_path,
            ],
            check=True,
            capture_output=True,
        )
    except (OSError, subprocess.CalledProcessError):
        return None
    return so_path


def _load(name: str, source: str) -> Optional[ctypes.CDLL]:
    if name in _LIBS:
        return _LIBS[name]
    path = _build_lib(name, source)
    lib = ctypes.CDLL(path) if path else None
    _LIBS[name] = lib
    return lib


def available() -> bool:
    return _load("azstore", "example_store.cpp") is not None


# ---------------------------------------------------------------------------
# Example store
# ---------------------------------------------------------------------------
class ExampleStore:
    """Native ring-buffered training-sample archive (see example_store.cpp).

    The host-side durable twin of the on-device replay ring: the coach can
    mirror samples here and ``save``/``load`` them across runs — the
    reference's ``{iteration}.examples`` files (coach.rs:159-167) without
    the absolute-path bug (D6) and with a checksum."""

    def __init__(self, capacity: int, feat_size: int, num_actions: int):
        lib = _load("azstore", "example_store.cpp")
        if lib is None:
            raise RuntimeError("native example store unavailable (no g++?)")
        self._lib = lib
        self._configure(lib)
        self.feat_size = feat_size
        self.num_actions = num_actions
        self._h = lib.az_store_create(capacity, feat_size, num_actions)
        if not self._h:
            raise MemoryError("az_store_create failed")

    @staticmethod
    def _configure(lib):
        u64, u32 = ctypes.c_uint64, ctypes.c_uint32
        fp = ctypes.POINTER(ctypes.c_float)
        lib.az_store_create.restype = ctypes.c_void_p
        lib.az_store_create.argtypes = [u64, u32, u32]
        lib.az_store_destroy.argtypes = [ctypes.c_void_p]
        for fn in ("az_store_count", "az_store_total", "az_store_capacity"):
            getattr(lib, fn).restype = u64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.az_store_append.argtypes = [ctypes.c_void_p, fp, fp, fp, u64]
        lib.az_store_read.restype = u64
        lib.az_store_read.argtypes = [ctypes.c_void_p, u64, u64, fp, fp, fp]
        lib.az_store_save.restype = ctypes.c_int
        lib.az_store_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.az_store_load.restype = ctypes.c_int
        lib.az_store_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p]

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.az_store_destroy(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.az_store_count(self._h))

    @property
    def total(self) -> int:
        return int(self._lib.az_store_total(self._h))

    def append(self, feats: np.ndarray, pis: np.ndarray, values: np.ndarray):
        n = len(values)
        feats = np.ascontiguousarray(feats, np.float32).reshape(n, -1)
        pis = np.ascontiguousarray(pis, np.float32).reshape(n, -1)
        values = np.ascontiguousarray(values, np.float32).reshape(n)
        assert feats.shape[1] == self.feat_size
        assert pis.shape[1] == self.num_actions
        fp = ctypes.POINTER(ctypes.c_float)
        self._lib.az_store_append(
            self._h,
            feats.ctypes.data_as(fp),
            pis.ctypes.data_as(fp),
            values.ctypes.data_as(fp),
            n,
        )

    def read(self, start: int, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        feats = np.empty((n, self.feat_size), np.float32)
        pis = np.empty((n, self.num_actions), np.float32)
        values = np.empty((n,), np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        got = int(
            self._lib.az_store_read(
                self._h,
                start,
                n,
                feats.ctypes.data_as(fp),
                pis.ctypes.data_as(fp),
                values.ctypes.data_as(fp),
            )
        )
        return feats[:got], pis[:got], values[:got]

    def save(self, path: str) -> None:
        rc = self._lib.az_store_save(self._h, path.encode())
        if rc != 0:
            raise IOError(f"az_store_save failed rc={rc}")

    def load(self, path: str) -> None:
        rc = self._lib.az_store_load(self._h, path.encode())
        if rc != 0:
            raise IOError(f"az_store_load failed rc={rc}")


# ---------------------------------------------------------------------------
# MCTS oracle
# ---------------------------------------------------------------------------
def oracle_search(
    board: np.ndarray,
    heights: np.ndarray,
    num_sims: int,
    cpuct: float = 1.0,
    max_depth: int = 64,
) -> Optional[np.ndarray]:
    """Sequential uniform-prior PUCT search on a canonical connect-four
    position; returns root visit counts f32[7] (None if no toolchain)."""
    lib = _load("azoracle", "mcts_oracle.cpp")
    if lib is None:
        return None
    lib.az_oracle_search.argtypes = [
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int,
        ctypes.c_float,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    board = np.ascontiguousarray(board, np.int8).reshape(42)
    heights = np.ascontiguousarray(heights, np.int8).reshape(7)
    counts = np.zeros(7, np.float32)
    lib.az_oracle_search(
        board.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        heights.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        num_sims,
        cpuct,
        max_depth,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return counts


# ---------------------------------------------------------------------------
# Transposition (DAG) oracle — SURVEY §7(c) quantification
# ---------------------------------------------------------------------------
_TT_GAMES = {"connect_four": (0, 42, 7), "othello": (1, 64, 65)}


def _tt_lib():
    lib = _load("azttoracle", "tt_oracle.cpp")
    if lib is None:
        return None
    if not getattr(lib, "_configured", False):
        i8p = ctypes.POINTER(ctypes.c_int8)
        fp = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.az_tt_search.restype = ctypes.c_long
        lib.az_tt_search.argtypes = [
            ctypes.c_int, i8p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, fp,
        ]
        lib.az_tt_match.restype = None
        lib.az_tt_match.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64, i32p,
        ]
        lib._configured = True
    return lib


def tt_oracle_search(
    game_name: str,
    board: np.ndarray,
    num_sims: int,
    cpuct: float = 1.0,
    max_depth: int = 64,
    use_tt: bool = False,
) -> Optional[Tuple[np.ndarray, int]]:
    """Node-stats PUCT search with optional transposition-DAG dedup (the
    reference's `seen` semantics, node.rs:135/272-326). Returns (root
    child-node visit counts, dedup hit count)."""
    lib = _tt_lib()
    if lib is None:
        return None
    gid, cells, actions = _TT_GAMES[game_name]
    board = np.ascontiguousarray(board, np.int8).reshape(cells)
    counts = np.zeros(actions, np.float32)
    hits = lib.az_tt_search(
        gid,
        board.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        num_sims,
        cpuct,
        max_depth,
        1 if use_tt else 0,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return counts, int(hits)


def tt_oracle_match(
    game_name: str,
    num_games: int,
    num_sims: int,
    cpuct: float = 1.0,
    max_depth: int = 64,
    temp_moves: int = 8,
    seed: int = 1,
) -> Optional[Tuple[int, int, int]]:
    """Equal-sims head-to-head: DAG/TT search vs pure-tree search
    (seating swapped; first ``temp_moves`` plies sampled ∝ counts).
    Returns (tt_wins, tree_wins, draws)."""
    lib = _tt_lib()
    if lib is None:
        return None
    gid, _, _ = _TT_GAMES[game_name]
    out = np.zeros(3, np.int32)
    lib.az_tt_match(
        gid, num_games, num_sims, cpuct, max_depth, temp_moves, seed,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return int(out[0]), int(out[1]), int(out[2])
