"""The port's entry points (spacepharer_tpu_torch/graft_entry.py)
on the CPU: the scoring step against the JAX package's, and the
multi-shard dry run on the golden bundle's DBs against its exact host
oracle."""
import glob
import os

import numpy as np
import pytest
import torch

from spacepharer_tpu_torch import graft_entry


def test_dryrun_multichip_golden(golden):
    (qpath,) = {os.path.realpath(p) for p in
                glob.glob(os.path.join(golden, "tmp", "*", "qsetdb"))}
    shapes = graft_entry.dryrun_multichip(8, qpath,
                                          os.path.join(golden, "targets"),
                                          devices=["cpu"])
    assert shapes == [(2, 4), (4, 2)]


def test_entry_matches_jax_entry():
    import __graft_entry__ as jax_entry
    fn, args = graft_entry.entry(device="cpu")
    jfn, jargs = jax_entry.entry()
    np.testing.assert_array_equal(fn(*args).cpu().numpy(),
                                  np.asarray(jfn(*jargs)))


def test_entry_points_without_a_card_raise(golden, monkeypatch):
    """Neither entry point runs on the CPU unless the caller names it."""
    (qpath,) = {os.path.realpath(p) for p in
                glob.glob(os.path.join(golden, "tmp", "*", "qsetdb"))}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        graft_entry.dryrun_multichip(8, qpath,
                                     os.path.join(golden, "targets"))
