"""The port's process-wide step cache (``engine/stepcache.py``) and the
step-table key (``engine/aot.py``) against the reference's, mirroring
tests/test_spatial.py's step-cache tests: a second engine of one config
hits the cache, the keys tell depths and devices apart, the table's path
dedupes across seeds; ``step_ident`` scrubs the same fields as the
reference's, so seeds collide or differ alike with compression on and
off; the compilation-cache report is the reference's line."""
import threading

import pytest
import torch

from repro.config import SPBConfig as JSPB, TrainConfig as JTrain
from repro.configs import reduced_config as j_reduced
from repro.engine import aot as j_aot
from repro.engine import stepcache as j_stepcache
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import make_batch, reduced_config
from repro_torch.engine import FusedEngine, SPBEngine, aot, stepcache
from repro_torch.kernels import _build

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)


def _engine(seed, *, k=2, shared=True, arch="yi-6b", device="cpu"):
    return SPBEngine(reduced_config(arch),
                     TrainConfig(seed=seed, num_steps=16),
                     SPBConfig(mode="temporal", k=k), shared_cache=shared,
                     device=device)


def test_step_cache_cross_engine_hit():
    """Tenant 2 with the same (config, depth, device) builds nothing: its
    entries are GLOBAL hits, the entries stay at the number of distinct
    step keys, and the two sessions still train their own weights."""
    stepcache.GLOBAL.clear()
    batch = make_batch(reduced_config("yi-6b"), 2, 16, seed=0, device="cpu")
    a = _engine(0)
    miss = stepcache.GLOBAL.stats()
    b = _engine(1)
    hit = stepcache.GLOBAL.stats()
    assert miss["misses"] == miss["entries"] == len(a.depth_keys()) == 3
    assert hit["hits"] == 3 and hit["entries"] == miss["entries"]
    assert all(a.step_fn(k) is b.step_fn(k) for k in a.depth_keys())
    a.init_state(0)
    b.init_state(1)
    la = float(a.train_step(batch, 0, depth=2)["loss"])
    lb = float(b.train_step(batch, 0, depth=2)["loss"])
    assert la != lb


def test_private_table_without_shared_cache():
    stepcache.GLOBAL.clear()
    a, b = _engine(0, shared=False), _engine(0, shared=False)
    assert a.step_fn(2) is not b.step_fn(2)
    assert len(stepcache.GLOBAL) == 0


def test_step_cache_keys_distinguish_depth_and_device():
    e = _engine(0)
    k2, k4 = e.step_cache_key(2), e.step_cache_key(4)
    assert k2 != k4 and k2[1] == "2" and e.step_cache_key(None)[1] == "full"
    fp = stepcache.device_fingerprint(e.device)
    assert k2[-1] == fp == stepcache.device_fingerprint("cpu")
    assert hash(fp) == hash(stepcache.device_fingerprint(torch.device("cpu")))
    meta = _engine(0, device="meta")
    assert meta.step_cache_key(2)[:2] == k2[:2]
    assert meta.step_cache_key(2) != k2      # the device participates
    fused = FusedEngine(reduced_config("yi-6b"), TrainConfig(seed=0,
                                                             num_steps=16),
                        SPBConfig(mode="temporal", k=2), num_jobs=3,
                        device="cpu")
    assert fused.step_cache_key(2) == k2 + (("fused", 3),)


def test_aot_cache_path_dedupes_across_seeds(tmp_path):
    """Same (config, depths, device) => same table path whatever the job
    seed; another arch or k => another path."""
    batch = make_batch(reduced_config("yi-6b"), 2, 16, seed=0, device="cpu")
    a, b = _engine(0), _engine(7)
    root = str(tmp_path)
    pa = a.aot_cache_path(a.batch_specs_like(batch), root)
    assert pa == b.aot_cache_path(b.batch_specs_like(batch), root)
    c = _engine(0, k=4)
    assert c.aot_cache_path(c.batch_specs_like(batch), root) != pa
    d = _engine(0, arch="mamba2-2.7b")
    dbatch = make_batch(reduced_config("mamba2-2.7b"), 2, 16, seed=0,
                        device="cpu")
    assert d.aot_cache_path(d.batch_specs_like(dbatch), root) != pa
    bigger = make_batch(reduced_config("yi-6b"), 4, 16, seed=0, device="cpu")
    assert a.aot_cache_path(a.batch_specs_like(bigger), root) != pa


@pytest.mark.parametrize("compression", ["none", "topk", "lowrank"])
def test_step_ident_scrubs_the_reference_fields(compression):
    """The same TrainConfig fields leave the ident in both packages: the
    checkpoint and log knobs always, the seed only without compression."""
    kw = dict(seed=5, compression=compression, checkpoint_every=3,
              checkpoint_dir="x", log_every=2, keep_checkpoints=1)
    ours = aot.step_ident(reduced_config("yi-6b"), TrainConfig(**kw),
                          SPBConfig(mode="temporal", k=2),
                          zero1=False, donate=True)
    ref = j_aot.step_ident(j_reduced("yi-6b"), JTrain(**kw),
                           JSPB(mode="temporal", k=2), zero1=False,
                           donate=True)
    assert ours["train"] == ref["train"]
    assert ours["spb"] == ref["spb"]
    # the port's one key more: the layer-recompute policy a step closes
    # over (the reference reads it from a context variable its key skips)
    assert set(ours) == set(ref) | {"remat"} and ours["remat"] == "none"
    assert ("seed" in ours["train"]) == (compression != "none")


@pytest.mark.parametrize("compression", ["none", "topk"])
def test_seeds_collide_or_differ_alike(compression):
    """Two seeds share one key in both packages without compression, and
    get two keys in both with it."""
    def same(pkg_ident, cfg, tcfg_cls, spb):
        idents = [pkg_ident(cfg, tcfg_cls(seed=s, compression=compression),
                            spb, zero1=False, donate=True) for s in (0, 1)]
        return idents[0] == idents[1]

    ours = same(aot.step_ident, reduced_config("yi-6b"), TrainConfig,
                SPBConfig(mode="temporal", k=2))
    ref = same(j_aot.step_ident, j_reduced("yi-6b"), JTrain,
               JSPB(mode="temporal", k=2))
    assert ours == ref == (compression == "none")
    engines = [SPBEngine(reduced_config("yi-6b"),
                         TrainConfig(seed=s, compression=compression),
                         SPBConfig(mode="temporal", k=2), device="cpu")
               for s in (0, 1)]
    keys = [e.step_cache_key(2) for e in engines]
    assert (keys[0] == keys[1]) == ours


def test_step_cache_semantics_match_the_reference():
    """``get_or_build`` / ``stats`` / ``clear`` / ``len`` behave as the
    reference's, including a racing duplicate build counted as a hit."""
    for cache in (stepcache.StepCache(), j_stepcache.StepCache()):
        built = []
        f = cache.get_or_build("k", lambda: built.append(1) or (lambda: 1))
        assert cache.get_or_build("k", lambda: None) is f
        assert cache.stats() == {"hits": 1, "misses": 1, "entries": 1}
        assert len(cache) == 1 and built == [1]
        gate = threading.Barrier(4)

        def build():
            gate.wait()
            return object()

        got = []
        threads = [threading.Thread(target=lambda: got.append(
            cache.get_or_build("race", build))) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len({id(g) for g in got}) == 1
        assert cache.stats() == {"hits": 4, "misses": 2, "entries": 2}
        cache.clear()
        assert cache.stats() == {"hits": 0, "misses": 0, "entries": 0}


def test_persistent_compilation_cache_points_the_builds(tmp_path,
                                                        monkeypatch):
    """``enable_persistent_compilation_cache`` moves the kernel-library
    directory (and reports what is already there); the report line is
    the reference's for the same counts."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    d = tmp_path / "cc"
    assert stepcache.enable_persistent_compilation_cache(d) == 0
    assert _build.BUILD_DIR == d
    assert _build.lib_path("flash_fwd").parent == d
    assert stepcache.persistent_cache_report(d, 0) == \
        j_stepcache.persistent_cache_report(d, 0)
    (d / "libflash_fwd-0123.so").write_bytes(b"")
    (d / "libssd_bwd-4567.so").write_bytes(b"")
    line = stepcache.persistent_cache_report(d, 0)
    assert line == j_stepcache.persistent_cache_report(d, 0)
    assert "2 new entries (miss), 2 total" in line
    assert stepcache.enable_persistent_compilation_cache(d) == 2
    assert "0 new entries (hit" in stepcache.persistent_cache_report(d, 2)
