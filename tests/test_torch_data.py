"""The port's host data library (``dmlc_core_tpu_torch.data``) against
the reference's ``dmlc_core_tpu.data``.

The same seeded files go through both packages and the containers must be
equal bit for bit (compared as ``save`` bytes, which cover every array and
scalar of a container): ``RowBlockIter.create`` over libsvm (weights and
qids), csv (typed ``int32`` values too), libfm, 64-bit ids, and
``part``/``npart`` splits; ``RowBlockContainer`` ``save`` bytes, each
package loading the other's file, ``slice``, ``take``, ``from_blocks``
and row views; the shard cache's epoch-2 replay against epoch 1, with the
reference's ``pipeline_stats`` keys; a Python-registered parser,
``on_error="skip"`` over one that raises, and the factories' refusals;
``ElasticRowBlockIter`` on ``LocalLeases`` (the same shard order and
batches for the same ``(num_shards, shuffle_window, run_id, epoch)``).
Elastic mode without ``leases=`` raises in the port: the tracker's
heartbeat monitor is not ported. The reference's native core comes from
the locked build (``tests/torch_reference_native.py``).
"""

import io
import os

import numpy as np
import pytest

from dmlc_core_tpu import data as ref_data
from dmlc_core_tpu.base import DMLCError as RefError
from dmlc_core_tpu.io import native as ref_native
from tests.torch_reference_native import reference_native  # noqa: F401

from dmlc_core_tpu_torch import data
from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.io import native


def _libsvm(path, rows=1500, seed=5):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            k = int(rng.integers(0, 9))
            ids = np.sort(rng.choice(40, size=k, replace=False))
            feats = " ".join(f"{j}:{rng.uniform(-3, 3):.5f}" for j in ids)
            f.write(f"{i % 2}:{0.5 + (i % 3)} qid:{i // 10} {feats}\n")
    return str(path)


def _csv(path, rows=1500, seed=6, ints=False):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            if ints:
                cells = [str(int(v)) for v in rng.integers(-50, 50, 6)]
            else:
                cells = [f"{rng.uniform(-3, 3):.5f}" for _ in range(6)]
                cells[i % 6] = ""
            f.write(f"{i % 2}," + ",".join(cells) + "\n")
    return str(path)


def _libfm(path, rows=1500, seed=7):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            feats = " ".join(f"{j % 4}:{int(rng.integers(0, 1 << 20))}:"
                             f"{rng.uniform(0, 2):.4f}" for j in range(7))
            f.write(f"{i % 2} {feats}\n")
    return str(path)


def _big_ids(path, rows=600, seed=8):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            ids = np.sort(rng.choice(1 << 40, size=3, replace=False))
            f.write(f"{i % 2} " + " ".join(f"{int(j)}:1.5" for j in ids)
                    + "\n")
    return str(path)


FILES = {
    "libsvm_weight_qid": (_libsvm, "", {}),
    "csv": (_csv, "?format=csv&label_column=0", {}),
    "csv_int32": (lambda p: _csv(p, ints=True),
                  "?format=csv&label_column=0&dtype=int32", {}),
    "libfm": (_libfm, "?format=libfm", {}),
    "index64": (_big_ids, "", {"index64": True}),
}


def saved(c) -> bytes:
    buf = io.BytesIO()
    c.save(buf)
    return buf.getvalue()


def _make(tmp_path, name):
    writer, query, kw = FILES[name]
    return writer(tmp_path / f"{name}.txt") + query, kw


@pytest.mark.parametrize("name", sorted(FILES))
@pytest.mark.parametrize("part,npart", [(0, 1), (0, 3), (2, 3)])
def test_rowblockiter_eager_equals_reference(tmp_path, name, part, npart):
    uri, kw = _make(tmp_path, name)
    (got,) = list(data.RowBlockIter.create(uri, part, npart, **kw))
    (want,) = list(ref_data.RowBlockIter.create(uri, part, npart, **kw))
    assert got.size == want.size > 0
    assert saved(got) == saved(want)
    it = data.RowBlockIter.create(uri, part, npart, **kw)
    assert it.num_col == want.num_col
    assert it.bytes_read() > 0
    it.close()


def test_container_save_load_across_packages(tmp_path):
    uri, _ = _make(tmp_path, "libsvm_weight_qid")
    (c,) = list(data.RowBlockIter.create(uri))
    (r,) = list(ref_data.RowBlockIter.create(uri))
    blob = saved(c)
    assert blob == saved(r)
    # two blocks back to back, each package reading the other's stream
    for reader, writer in ((data, r), (ref_data, c)):
        buf = io.BytesIO()
        writer.save(buf)
        writer.save(buf)
        buf.seek(0)
        got = []
        while True:
            x = reader.RowBlockContainer()
            if not x.load(buf):
                break
            got.append(x)
        assert len(got) == 2 and all(saved(x) == blob for x in got)
    trunc = io.BytesIO(blob[:-3])
    with pytest.raises(DMLCError, match="truncated"):
        data.RowBlockContainer().load(trunc)


def test_slice_take_from_blocks_rows(tmp_path):
    uri, _ = _make(tmp_path, "libsvm_weight_qid")
    (c,) = list(data.RowBlockIter.create(uri))
    (r,) = list(ref_data.RowBlockIter.create(uri))
    assert saved(c.slice(100, 400)) == saved(r.slice(100, 400))
    assert saved(c.slice(7, 7)) == saved(r.slice(7, 7))
    rows = np.random.default_rng(1).integers(0, c.size, 333)
    assert saved(c.take(rows)) == saved(r.take(rows))
    assert saved(c.take([])) == saved(r.take([]))
    parts = [c.slice(0, 10), c.take([5, 5, 3]), c.slice(500, c.size)]
    rparts = [r.slice(0, 10), r.take([5, 5, 3]), r.slice(500, r.size)]
    assert saved(data.RowBlockContainer.from_blocks(parts)) == \
        saved(ref_data.RowBlockContainer.from_blocks(rparts))
    grown = data.RowBlockContainer()
    grown.append_block(parts[0])
    grown.append_block(parts[1])
    rgrown = ref_data.RowBlockContainer()
    rgrown.append_block(rparts[0])
    rgrown.append_block(rparts[1])
    assert saved(grown) == saved(rgrown)
    w = np.linspace(-1, 1, 40)
    for i in (0, 17, c.size - 1):
        a, b = c[i], r[i]
        assert (a.label, a.weight, a.qid, a.length) == \
            (b.label, b.weight, b.qid, b.length)
        assert a.sdot(w) == b.sdot(w)
    assert c.mem_cost_bytes() == r.mem_cost_bytes()
    with pytest.raises(DMLCError):
        c.slice(20, 10)
    with pytest.raises(DMLCError, match="out of range"):
        c.take([c.size])
    with pytest.raises(IndexError):
        c[c.size]


@pytest.mark.parametrize("name", ["libsvm_weight_qid", "csv", "libfm"])
def test_shard_cache_replay_equals_first_epoch(tmp_path, name):
    uri, _ = _make(tmp_path, name)
    plain = saved(ref_data.RowBlockContainer.from_blocks(
        list(ref_data.RowBlockIter.create(uri))))
    stats = []
    for pkg, cdir in ((data, "c_port"), (ref_data, "c_ref")):
        with pkg.RowBlockIter.create(uri, cache_dir=str(tmp_path / cdir)) \
                as it:
            ep1 = pkg.RowBlockContainer.from_blocks(list(it))
            stats.append(it.pipeline_stats())
            ep2 = pkg.RowBlockContainer.from_blocks(list(it))
            assert saved(ep1) == saved(ep2) == plain
            assert it.pipeline_stats() is None  # the replay: no pipeline
        assert any(f.endswith(".dshard")
                   for f in os.listdir(tmp_path / cdir))
    assert set(stats[0]) == set(stats[1])
    assert stats[0]["blocks_delivered"] == stats[1]["blocks_delivered"]


def test_cache_sugar_env_and_refusals(tmp_path, monkeypatch):
    uri, _ = _make(tmp_path, "libsvm_weight_qid")
    plain = saved(data.RowBlockContainer.from_blocks(
        list(data.RowBlockIter.create(uri))))
    cdir = tmp_path / "sugar"
    it = data.RowBlockIter.create(uri + "#cachefile=" + str(cdir))
    assert saved(data.RowBlockContainer.from_blocks(list(it))) == plain
    assert any(f.endswith(".dshard") for f in os.listdir(cdir))
    monkeypatch.setenv("DMLC_DATA_CACHE_DIR", str(tmp_path / "env"))
    with native.NativeParser(uri) as p:
        assert sum(b.num_rows for b in p) == 1500
    assert any(f.endswith(".dshard")
               for f in os.listdir(tmp_path / "env"))
    monkeypatch.delenv("DMLC_DATA_CACHE_DIR")
    for pkg, err in ((data, DMLCError), (ref_data, RefError)):
        with pytest.raises(err, match="never|auto|refresh"):
            pkg.Parser.create(uri, cache_dir=str(cdir), cache="sometimes")
        with pytest.raises(err, match="takes options as URI args"):
            pkg.Parser.create(uri, label_column=0)
        with pytest.raises(err, match="unknown data format"):
            pkg.Parser.create(uri, fmt="nosuchformat")
        with pytest.raises(err, match="on_error"):
            pkg.RowBlockIter(None, eager=True, on_error="ignore")
    with pytest.raises(DMLCError):
        native.NativeParser(uri, cache_dir=str(cdir), cache="bogus")


class _Blocks:
    """A Python parser over pre-built containers; ``fail_at`` pulls
    raise the package's DMLCError."""

    def __init__(self, blocks, err, fail_at=()):
        self.blocks, self.err, self.fail_at = blocks, err, set(fail_at)
        self.i = 0

    def next_block(self):
        self.i += 1
        if self.i in self.fail_at:
            raise self.err(f"pull {self.i} failed")
        k = self.i - 1 - sum(1 for f in self.fail_at if f < self.i)
        return self.blocks[k] if k < len(self.blocks) else None

    def before_first(self):
        self.i = 0

    def bytes_read(self):
        return 0


@pytest.mark.parametrize("fail_at", [(), (2,), (1, 3)])
def test_registered_parser_and_on_error_skip(tmp_path, fail_at):
    uri, _ = _make(tmp_path, "libsvm_weight_qid")
    name = f"torch_parity_blocks_{len(fail_at)}"
    out = {}
    for pkg, err in ((data, DMLCError), (ref_data, RefError)):
        (whole,) = list(pkg.RowBlockIter.create(uri))
        blocks = [whole.slice(0, 300), whole.slice(300, 1000),
                  whole.slice(1000, 1500)]

        @pkg.register_parser(name)
        def make(uri, part, npart, **kw):
            return _Blocks(blocks, err, fail_at)

        try:
            it = pkg.RowBlockIter(pkg.Parser.create(uri + f"?format={name}"),
                                  eager=True, on_error="skip")
            (got,) = list(it)
            out[pkg.__name__] = (saved(got), it.skipped_batches,
                                 it.io_stats()["skipped_batches"],
                                 it.pipeline_stats())
            with pytest.raises(err, match="Python-registered parser"):
                pkg.Parser.create(uri + f"?format={name}&cache=auto")
            with pytest.raises(err, match="Python-registered parser"):
                pkg.Parser.create(uri + f"?format={name}",
                                  cache_dir=str(tmp_path))
            if fail_at:
                strict = pkg.RowBlockIter(
                    pkg.Parser.create(uri + f"?format={name}"), eager=True)
                with pytest.raises(err, match="failed"):
                    list(strict)
        finally:
            pkg.PARSER_REGISTRY.remove(name)
    got, want = out[data.__name__], out[ref_data.__name__]
    assert got == want
    assert got[1] == len(fail_at) and got[3] is None


def test_skip_gives_up_after_three_consecutive_failures(tmp_path):
    uri, _ = _make(tmp_path, "libsvm_weight_qid")
    (whole,) = list(data.RowBlockIter.create(uri))
    src = _Blocks([whole.slice(0, 10), whole.slice(10, 20)], DMLCError,
                  fail_at=(2, 3, 4))
    it = data.RowBlockIter(src, eager=True, on_error="skip")
    (got,) = list(it)
    assert got.size == 10 and it.skipped_batches == 3
    assert "pull 4 failed" in it.last_error


@pytest.mark.parametrize("num_shards,window,run_id,epoch", [
    (4, 0, 0, 0), (5, 64, 3, 1), (3, 100, 0, 2)])
def test_elastic_on_local_leases_matches_reference(tmp_path, num_shards,
                                                   window, run_id, epoch):
    uri, _ = _make(tmp_path, "libsvm_weight_qid")

    def stream(pkg, completed=()):
        it = pkg.RowBlockIter.create(
            uri, elastic=True, leases=pkg.LocalLeases(num_shards,
                                                      completed=completed),
            num_shards=num_shards, shuffle_window=window, run_id=run_id,
            epoch=epoch)
        order, batches = [], []
        for shard, bs in it.shards():
            order.append(shard)
            batches += [saved(b) for b in bs]
        return order, batches, it.state(), it.bytes_read()

    got, want = stream(data), stream(ref_data)
    assert got == want
    assert got[0] == list(range(num_shards))
    assert stream(data, completed=[1]) == stream(ref_data, completed=[1])
    # URI sugar gives the same iterator
    sugar = data.RowBlockIter.create(
        uri + f"?elastic=1&num_shards={num_shards}"
        f"&shuffle_window={window}&run_id={run_id}",
        leases=data.LocalLeases(num_shards), epoch=epoch)
    assert [saved(b) for b in sugar] == got[1]


def test_elastic_refusals(tmp_path, monkeypatch):
    uri, _ = _make(tmp_path, "libsvm_weight_qid")
    with pytest.raises(DMLCError, match="queue 1, item 4"):
        data.RowBlockIter.create(uri, elastic=True, num_shards=2)
    with pytest.raises(DMLCError, match="num_shards > 0"):
        data.RowBlockIter.create(uri, elastic=True,
                                 leases=data.LocalLeases(2))
    with pytest.raises(DMLCError, match="legacy"):
        data.RowBlockIter.create(uri + "#" + str(tmp_path / "x.cache"),
                                 elastic=True, leases=data.LocalLeases(2),
                                 num_shards=2)
    with pytest.raises(DMLCError, match="not an integer"):
        data.RowBlockIter.create(uri + "?elastic=1&num_shards=x",
                                 leases=data.LocalLeases(2))
    with pytest.raises(DMLCError, match="num_shards must be"):
        data.LocalLeases(0)
    # the env opt-in covers only the default (0, 1) split
    monkeypatch.setenv("DMLC_ELASTIC_SHARDS", "1")
    monkeypatch.setenv("DMLC_TRACKER_NUM_SHARDS", "3")
    static = data.RowBlockIter.create(uri, part=1, npart=2)
    assert isinstance(static, data.RowBlockIter)
    elastic = data.RowBlockIter.create(uri, leases=data.LocalLeases(3))
    assert isinstance(elastic, data.ElasticRowBlockIter)
    assert elastic.num_shards == 3


def test_local_leases_accounting():
    for pkg in (data, ref_data):
        leases = pkg.LocalLeases(3, completed=[0])
        a = leases.acquire_lease(0)
        b = leases.acquire_lease(0)
        leases.release_lease(0, a)
        c = leases.acquire_lease(0)
        assert (a, b, c) == (1, 2, 1)
        leases.complete_lease(0, b)
        with pytest.raises(TimeoutError):
            leases.acquire_lease(0, timeout=0.05)
        leases.complete_lease(0, c)
        assert leases.acquire_lease(0) is None
        assert leases.acquire_lease(1) == 1  # a new epoch's pool


def test_io_stats_keys_match_reference(tmp_path):
    uri, _ = _make(tmp_path, "libsvm_weight_qid")
    it = data.RowBlockIter.create(uri)
    ref_it = ref_data.RowBlockIter.create(uri)
    assert set(it.io_stats()) == set(ref_it.io_stats())
    assert set(native.io_retry_stats()) == set(ref_native.io_retry_stats())
    native.reset_io_retry_stats()
    assert all(v == 0 for v in native.io_retry_stats().values())
    with native.NativeParser(uri, chunks_in_flight=2, nthread=2) as p:
        assert sum(b.num_rows for b in p) == 1500
        stats = p.pipeline_stats()
        assert stats["capacity"] == 2 and stats["workers"] == 2
        assert p.io_stats() == native.io_retry_stats()
    with native.NativeParser(uri, threaded=False) as p:
        assert p.pipeline_stats() is None
