"""Native (C) hot-path components, built on demand with the system
compiler and loaded via ctypes. Falls back to the NumPy implementations
when no compiler is available."""
import ctypes
import hashlib
import os
import subprocess
import sys
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "_spacepharer_native.so")
_HASH_PATH = _LIB_PATH + ".hash"
_SOURCES = [os.path.join(_DIR, "tantan_native.c"),
            os.path.join(_DIR, "sw_native.c"),
            os.path.join(_DIR, "search_native.c"),
            os.path.join(_DIR, "banded_native.c")]

_lib = None
_tried = False


def _src_hash() -> str:
    h = hashlib.sha256()
    for s in _SOURCES:
        with open(s, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def _build(want_hash: str) -> bool:
    # Concurrent processes (pytest-xdist workers, forked searches) may
    # build at once: each compiles to its own temporary name and
    # os.replace()s it into place, so a loader never maps a half-written
    # .so; the hash file follows the same protocol, after the library.
    cc = os.environ.get("CC", "cc")
    tag = f".{os.getpid()}.{threading.get_ident()}.tmp"
    tmp_lib, tmp_hash = _LIB_PATH + tag, _HASH_PATH + tag
    cmd = [cc, "-O2", "-shared", "-fPIC", "-pthread",
           "-o", tmp_lib] + _SOURCES
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp_lib, _LIB_PATH)
        with open(tmp_hash, "w") as fh:
            fh.write(want_hash)
        os.replace(tmp_hash, _HASH_PATH)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError) as e:
        for path in (tmp_lib, tmp_hash):
            if os.path.exists(path):
                os.remove(path)
        print(f"spacepharer_tpu_torch: native build failed ({e}); "
              "using NumPy fallbacks", file=sys.stderr)
        return False


def get_lib():
    """Returns the loaded native library or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # The rebuild is keyed on a content hash of the sources (mtimes do
    # not survive git checkout, so a stale committed .so could
    # otherwise load silently).
    want = _src_hash()
    have = None
    if os.path.exists(_HASH_PATH):
        try:
            with open(_HASH_PATH) as fh:
                have = fh.read().strip()
        except OSError:
            pass
    if not os.path.exists(_LIB_PATH) or have != want:
        if not _build(want):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.tantan_mask_batch.restype = None
    lib.tantan_mask_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_void_p,
    ]
    lib.sw_forward.restype = None
    lib.sw_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.sw_forward_batch.restype = None
    lib.sw_forward_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.gather_ranges.restype = None
    lib.gather_ranges.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.reverse_codons_ranges.restype = None
    lib.reverse_codons_ranges.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.translate_flat.restype = None
    lib.translate_flat.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.find_orfs_strand.restype = ctypes.c_int64
    lib.find_orfs_strand.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.build_postings.restype = ctypes.c_int64
    lib.build_postings.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.build_postings_v2.restype = ctypes.c_int64
    lib.build_postings_v2.argtypes = lib.build_postings.argtypes
    lib.build_postings_v3.restype = ctypes.c_int64
    lib.build_postings_v3.argtypes = (lib.build_postings.argtypes
                                      + [ctypes.c_void_p, ctypes.c_void_p])
    lib.postings_free_arena.restype = None
    lib.postings_free_arena.argtypes = []
    lib.prefilter_finalize.restype = ctypes.c_int64
    lib.prefilter_finalize.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.prefilter_finalize_release.restype = None
    lib.prefilter_finalize_release.argtypes = []
    lib.prefilter_finalize_live.restype = ctypes.c_int64
    lib.prefilter_finalize_live.argtypes = []
    lib.prefilter_batch.restype = ctypes.c_int64
    lib.prefilter_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,          # queries
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,          # seed
        ctypes.c_int32,                                            # bias on
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,           # pattern
        ctypes.c_int32, ctypes.c_int32,                            # thr, X
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,          # uniq
        ctypes.c_void_p, ctypes.c_void_p,                          # postings
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,          # targets
        ctypes.c_void_p, ctypes.c_int32,                           # ungapped
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,            # params
    ]
    lib.prefilter_batch_fetch.restype = ctypes.c_int64
    lib.prefilter_batch_fetch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.prefilter_finalize_batch.restype = ctypes.c_int64
    lib.prefilter_finalize_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,         # streams
        ctypes.c_int64,                                            # queries
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,         # letters
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,           # ungapped
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,          # targets
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,            # params
    ]
    lib.local_bias_batch.restype = None
    lib.local_bias_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,          # queries
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,          # matrix
        ctypes.c_int32, ctypes.c_void_p,                           # on, out
    ]
    lib.prefilter_batch_free.restype = None
    lib.prefilter_batch_free.argtypes = []
    lib.scan_contigs_batch.restype = ctypes.c_int64
    lib.scan_contigs_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,          # contigs
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,         # luts
        ctypes.c_void_p, ctypes.c_void_p,                          # luts
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,            # limits
        ctypes.c_int32,                                            # mode
        ctypes.c_void_p,                                           # out
    ]
    lib.scan_contigs_fetch.restype = ctypes.c_int64
    lib.scan_contigs_fetch.argtypes = [ctypes.c_void_p] * 6
    lib.scan_contigs_free.restype = None
    lib.scan_contigs_free.argtypes = []
    lib.align_forward_batch.restype = None
    lib.align_forward_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,          # queries
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,          # matrix
        ctypes.c_int32,                                            # bias on
        ctypes.c_void_p, ctypes.c_void_p,                          # targets
        ctypes.c_void_p, ctypes.c_void_p,                          # cands
        ctypes.c_int32, ctypes.c_int32,                            # gaps
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,         # out
    ]
    lib.align_traceback_batch.restype = None
    lib.align_traceback_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,                          # queries
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,          # matrix
        ctypes.c_int32,                                            # bias on
        ctypes.c_void_p, ctypes.c_void_p,                          # targets
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,          # pairs
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,         # fwd res
        ctypes.c_int32, ctypes.c_int32,                            # gaps
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,         # out
        ctypes.c_void_p, ctypes.c_void_p,                          # out
        ctypes.c_void_p, ctypes.c_void_p,                          # bt
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,         # rle
    ]
    lib.nucl_rescore_batch.restype = None
    lib.nucl_rescore_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,                          # pool
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,          # rows
        ctypes.c_void_p, ctypes.c_void_p,                          # starts
        ctypes.c_void_p, ctypes.c_void_p,                          # bt
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,          # enc/mat
        ctypes.c_int32, ctypes.c_int32,                            # gaps
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,         # out
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,         # new bt
    ]
    lib.banded_align_batch.restype = ctypes.c_int64
    lib.banded_align_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,                          # queries
        ctypes.c_void_p, ctypes.c_void_p,                          # targets
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,         # pairs
        ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int32,                           # matrix
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,            # costs
        ctypes.c_int32,                                            # threads
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,         # out
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,         # out
        ctypes.c_void_p,                                           # out
    ]
    lib.orf_nucl_ranges.restype = None
    lib.orf_nucl_ranges.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,                          # contigs
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,         # orf meta
        ctypes.c_void_p, ctypes.c_int64,                           # keys
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,          # luts
        ctypes.c_void_p, ctypes.c_void_p,                          # out
    ]
    _lib = lib
    return _lib
