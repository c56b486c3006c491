"""The port's remote I/O against the reference's.

The same seeded files go through both packages' ``io/native.py``:
``NativeInputSplit`` records and chunks (text and recordio, every
``nsplit`` of 1-7, ``reset_partition``, ``before_first``) over local files,
the mock S3, the mock WebHDFS and the mock HTTP origin; ``LeasedSplit`` on
``LocalLeases``; ``list_directory`` and ``path_info`` on the same trees;
the remote-I/O counters under the same ``set_io_fault_plan``; a stalled
read ended by ``set_io_timeout_ms``; the WebHDFS delegation token and
Authorization header as the mock sees them; ``https://`` through the
port's own TLS helper (``ensure_tls_proxy``) against
``tests/mock_origin.py`` serving TLS with a self-signed certificate.
Each package loads its own build of the native core; the
reference's comes from the locked build (``tests/torch_reference_native.py``).
"""

import os
import ssl
import time

import numpy as np
import pytest

import tests.mock_origin as mock_origin
from dmlc_core_tpu import data as ref_data
from dmlc_core_tpu.base import DMLCError as RefError
from dmlc_core_tpu.io import native as ref_native
from test_s3 import _STATE as S3_STATE
from test_tls import _libsvm_corpus, cert_pair  # noqa: F401
from test_webhdfs import _PORT as HD_PORT
from test_webhdfs import _STATE as HD_STATE
from tests.torch_reference_native import reference_native  # noqa: F401

from dmlc_core_tpu_torch import data
from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.io import native
from dmlc_core_tpu_torch.io import tls_proxy

PKGS = {"port": native, "ref": ref_native}


def text_corpus(rows=701, seed=3) -> bytes:
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(rows):
        n = int(rng.integers(0, 6))
        feats = " ".join(f"{j}:{rng.uniform(-1, 1):.4f}"
                         for j in sorted(rng.choice(50, n, replace=False)))
        lines.append(f"{i % 2} {feats}".rstrip())
    return ("\n".join(lines) + "\n").encode()


def recordio_file(path, n=300, seed=4) -> str:
    rng = np.random.default_rng(seed)
    with native.NativeRecordIOWriter(str(path)) as w:
        for i in range(n):
            w.write_record(rng.integers(0, 256, int(rng.integers(0, 300)),
                                        dtype=np.uint8).tobytes())
    return str(path)


def split_records(pkg, uri, part, nsplit, split_type="text"):
    with pkg.NativeInputSplit(uri, part, nsplit, split_type) as s:
        return list(s)


def split_chunks(pkg, uri, part, nsplit, split_type="text"):
    with pkg.NativeInputSplit(uri, part, nsplit, split_type) as s:
        s.hint_chunk_size(4096)
        out = []
        while (c := s.next_chunk()) is not None:
            out.append(c)
        return out


@pytest.fixture
def local_files(tmp_path):
    text = tmp_path / "a.libsvm"
    text.write_bytes(text_corpus())
    return {"text": str(text),
            "recordio": recordio_file(tmp_path / "a.rec")}


@pytest.mark.parametrize("nsplit", range(1, 8))
@pytest.mark.parametrize("split_type", ["text", "recordio"])
def test_input_split_records_match_local(local_files, split_type, nsplit):
    uri = local_files[split_type]
    whole = []
    for part in range(nsplit):
        got = split_records(native, uri, part, nsplit, split_type)
        assert got == split_records(ref_native, uri, part, nsplit,
                                    split_type)
        assert split_chunks(native, uri, part, nsplit, split_type) == \
            split_chunks(ref_native, uri, part, nsplit, split_type)
        whole += got
    # the parts cover the source exactly once, in order
    assert whole == split_records(native, uri, 0, 1, split_type)


@pytest.mark.parametrize("split_type", ["text", "recordio"])
def test_reset_partition_before_first_and_size(local_files, split_type):
    uri = local_files[split_type]
    for pkg in PKGS.values():
        with pkg.NativeInputSplit(uri, 0, 3, split_type) as s:
            first = list(s)
            s.before_first()
            assert list(s) == first
            s.reset_partition(2, 3)
            assert list(s) == split_records(pkg, uri, 2, 3, split_type)
            s.reset_partition(1, 5)
            assert list(s) == split_records(pkg, uri, 1, 5, split_type)
            assert s.total_size() == os.path.getsize(uri)


@pytest.fixture(scope="module")
def http_origin():
    state, port, shutdown = mock_origin.serve_backend("http")
    yield state, f"http://127.0.0.1:{port}"
    shutdown()


@pytest.fixture
def remote(request, http_origin, local_files):
    """A URI of the local files' bytes on the named mock backend."""
    kind = request.param
    blobs = {k: open(v, "rb").read() for k, v in local_files.items()}
    if kind == "s3":
        for k, b in blobs.items():
            S3_STATE.objects[("bkt", f"torch-io/{k}")] = b
        yield {k: f"s3://bkt/torch-io/{k}" for k in blobs}
        for k in blobs:
            S3_STATE.objects.pop(("bkt", f"torch-io/{k}"), None)
    elif kind == "webhdfs":
        for k, b in blobs.items():
            HD_STATE.files[f"/torch-io/{k}"] = b
        yield {k: f"hdfs://127.0.0.1:{HD_PORT}/torch-io/{k}" for k in blobs}
        for k in blobs:
            HD_STATE.files.pop(f"/torch-io/{k}", None)
    else:
        state, base = http_origin
        for k, b in blobs.items():
            state.objects[f"/torch-io/{k}"] = b
        yield {k: f"{base}/torch-io/{k}" for k in blobs}


@pytest.mark.parametrize("remote", ["s3", "webhdfs", "http"],
                         indirect=True)
@pytest.mark.parametrize("split_type", ["text", "recordio"])
def test_input_split_records_match_remote(remote, local_files, split_type):
    uri = remote[split_type]
    for nsplit in (1, 3):
        for part in range(nsplit):
            got = split_records(native, uri, part, nsplit, split_type)
            assert got == split_records(ref_native, uri, part, nsplit,
                                        split_type)
            assert got == split_records(native, local_files[split_type],
                                        part, nsplit, split_type)


def test_leased_split_matches_reference(local_files):
    uri = local_files["text"]
    runs = {}
    for name, (pkg, dpkg) in {"port": (native, data),
                              "ref": (ref_native, ref_data)}.items():
        leases = dpkg.LocalLeases(5, completed=[2])
        with pkg.LeasedSplit(uri, leases, 5) as s:
            runs[name] = (list(s), list(s.consumed))
    assert runs["port"] == runs["ref"]
    assert runs["port"][1] == [0, 1, 3, 4]
    want = [r for k in (0, 1, 3, 4)
            for r in split_records(native, uri, k, 5)]
    assert runs["port"][0] == want
    with pytest.raises(DMLCError, match="num_shards > 0"):
        native.LeasedSplit(uri, data.LocalLeases(1), 0)


@pytest.mark.parametrize("where", ["local", "s3", "webhdfs"])
def test_list_directory_and_path_info_match(tmp_path, where):
    names = {"a.txt": b"x" * 10, "sub/b.txt": b"y" * 33, "sub/c/d": b"z"}
    if where == "local":
        for n, b in names.items():
            (tmp_path / n).parent.mkdir(parents=True, exist_ok=True)
            (tmp_path / n).write_bytes(b)
        root = str(tmp_path)
    elif where == "s3":
        for n, b in names.items():
            S3_STATE.objects[("bkt", f"tree/{n}")] = b
        root = "s3://bkt/tree"
    else:
        for n, b in names.items():
            HD_STATE.files[f"/tree/{n}"] = b
        root = f"hdfs://127.0.0.1:{HD_PORT}/tree"
    for recursive in (False, True):
        got = native.list_directory(root, recursive)
        assert got == ref_native.list_directory(root, recursive)
        assert any(p.endswith("a.txt") and size == 10 and t == "f"
                   for p, size, t in got)
    for uri in (root + "/a.txt", root + "/sub/b.txt"):
        assert native.path_info(uri) == ref_native.path_info(uri)
    assert native.path_info(root + "/sub/b.txt") == (33, False)


def test_fault_plan_counters_match(http_origin):
    state, base = http_origin
    payload = np.random.default_rng(5).integers(
        0, 256, 256 * 1024, dtype=np.uint8).tobytes()
    state.objects["/fault.bin"] = payload
    stats = {}
    for name, pkg in PKGS.items():
        pkg.reset_io_retry_stats()
        pkg.set_io_fault_plan("5xx:every=2")
        try:
            with pkg.NativeStream(base + "/fault.bin") as s:
                assert s.read_all() == payload
        finally:
            pkg.set_io_fault_plan("")
        stats[name] = pkg.io_retry_stats()
    assert stats["port"] == stats["ref"]
    assert stats["port"]["faults_injected"] >= 1
    assert stats["port"]["retries"] >= 1
    with pytest.raises(DMLCError):
        native.set_io_fault_plan("reset:every=oops")
    with pytest.raises(RefError):
        ref_native.set_io_fault_plan("reset:every=oops")


def test_io_timeout_ends_a_stalled_read(http_origin):
    state, base = http_origin
    state.objects["/hang.bin"] = b"h" * 4096
    state.stall_all, state.stall_seconds = True, 30.0
    try:
        for pkg, err in ((native, DMLCError), (ref_native, RefError)):
            pkg.set_io_timeout_ms(200)
            t0 = time.monotonic()
            try:
                with pytest.raises(err, match="timed out|deadline|short"):
                    with pkg.NativeStream(
                            base + "/hang.bin?io_deadline_ms=1000") as s:
                        s.read_all()
            finally:
                pkg.set_io_timeout_ms(0)
            assert time.monotonic() - t0 < 10
    finally:
        state.stall_all = False


@pytest.mark.parametrize("kind", ["delegation", "auth_header"])
def test_webhdfs_credentials_reach_the_mock(kind):
    HD_STATE.files["/sec/cred.txt"] = b"secret"
    uri = f"hdfs://127.0.0.1:{HD_PORT}/sec/cred.txt"
    seen = {}
    for name, pkg in PKGS.items():
        HD_STATE.requests.clear()
        HD_STATE.seen_auth_headers.clear()
        if kind == "delegation":
            HD_STATE.require_delegation = "tok-7"
            pkg.set_webhdfs_delegation_token("tok-7")
        else:
            HD_STATE.require_auth_header = "Negotiate dG9r"
            pkg.set_webhdfs_auth_header("Negotiate dG9r")
        try:
            with pkg.NativeStream(uri) as s:
                assert s.read_all() == b"secret"
        finally:
            pkg.set_webhdfs_delegation_token("")
            pkg.set_webhdfs_auth_header("")
            HD_STATE.require_delegation = None
            HD_STATE.require_auth_header = None
        seen[name] = (list(HD_STATE.requests),
                      list(HD_STATE.seen_auth_headers))
    assert seen["port"] == seen["ref"]
    if kind == "delegation":
        assert any("delegation=tok-7" in p for _, p in seen["port"][0])
    else:
        assert seen["port"][1] and set(seen["port"][1]) == {"Negotiate dG9r"}


@pytest.fixture
def tls_origin(cert_pair, monkeypatch):  # noqa: F811
    """``tests/mock_origin.py``'s http origin speaking TLS with a
    self-signed certificate; no helper configured, so the port's native
    opens start their own (``ensure_tls_proxy``)."""
    cert_file, key_file = cert_pair
    monkeypatch.setenv("DCT_TLS_CA", cert_file)
    monkeypatch.delenv("DCT_TLS_PROXY", raising=False)
    monkeypatch.delenv("DCT_TLS_AUTO", raising=False)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_file, key_file)
    state, port, shutdown = mock_origin.serve_backend("http", None, ctx)
    try:
        yield state, f"https://127.0.0.1:{port}"
    finally:
        shutdown()


def test_https_reads_through_the_ports_tls_helper(tls_origin):
    state, base = tls_origin
    corpus = _libsvm_corpus(rows=331)
    state.objects["/train.libsvm"] = corpus
    with native.NativeStream(base + "/train.libsvm") as s:
        assert s.read_all() == corpus
    assert not os.environ.get("DCT_TLS_PROXY")  # published, not setenv
    assert native.path_info(base + "/train.libsvm") == (len(corpus), False)
    got = [r for part in range(3)
           for r in split_records(native, base + "/train.libsvm", part, 3)]
    assert got == corpus.splitlines()
    rows = 0
    for part in range(3):
        with native.NativeParser(base + "/train.libsvm", part=part,
                                 npart=3) as p:
            rows += sum(b.num_rows for b in p)
    assert rows == 331
    # every part's reads went through the helper to the origin
    assert sum(r[0] == "GET" for r in state.requests) >= 3


def test_tls_proxy_relays_like_the_reference(tls_origin):
    """A ``TlsProxy`` of each package in front of the same origin: the
    same bytes; ``ensure_tls_proxy`` returns one address per process."""
    from dmlc_core_tpu.io import tls_proxy as ref_tls
    state, base = tls_origin
    state.objects["/blob.bin"] = bytes(range(256)) * 40
    import http.client
    got = {}
    for name, mod in (("port", tls_proxy), ("ref", ref_tls)):
        with mod.TlsProxy() as addr:
            host, port = addr.rsplit(":", 1)
            conn = http.client.HTTPConnection(host, int(port), timeout=10)
            conn.request("GET", base + "/blob.bin")
            got[name] = conn.getresponse().read()
            conn.close()
    assert got["port"] == got["ref"] == state.objects["/blob.bin"]
    assert tls_proxy.ensure_tls_proxy(export_env=False) == \
        tls_proxy.ensure_tls_proxy(export_env=False)


@pytest.mark.parametrize("uri,env", [
    ("https://h/x", {}),
    ("/data/f.libsvm?note=https://origin", {}),
    ("s3://b/k", {}),
    ("s3://b/k", {"S3_ENDPOINT": "http://127.0.0.1:9"}),
    ("s3://b/k", {"AWS_ENDPOINT": "https://e"}),
    ("azure://c/k", {"AZURE_ENDPOINT": "http://x"}),
    ("hdfs://n/p", {"WEBHDFS_NAMENODE": "https://nn:9871"}),
    ("/a;https://h/b", {}),
])
def test_uri_needs_tls_matches_reference(monkeypatch, uri, env):
    for k in ("S3_ENDPOINT", "AWS_ENDPOINT", "AZURE_ENDPOINT",
              "WEBHDFS_NAMENODE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert native._uri_needs_tls(uri) == ref_native._uri_needs_tls(uri)


def test_native_telemetry_controls_and_formats_doc(tmp_path, monkeypatch):
    assert native.parser_formats_doc() == ref_native.parser_formats_doc()
    native.native_telemetry_enable(True)
    native.native_trace_reset()
    native.native_telemetry_reset()
    assert all(c["value"] == 0 for c in
               native.native_telemetry_snapshot()["counters"])
    assert native.native_trace_snapshot()["spans"] == []
    # no DMLC_TRACE_DUMP: nothing lands, in both packages
    monkeypatch.delenv("DMLC_TRACE_DUMP", raising=False)
    assert native.native_flight_dump("x") is \
        ref_native.native_flight_dump("x") is False
    monkeypatch.setenv("DMLC_TRACE_DUMP", str(tmp_path))
    assert native.native_flight_dump("x") is \
        ref_native.native_flight_dump("x") is True
    assert os.listdir(tmp_path)  # one name per pid: the second overwrote
    native.native_telemetry_enable(False)
