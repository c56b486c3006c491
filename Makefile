# Top-level QA lanes (reference runs lint + gtest + cmake + TSan + s390x-BE
# on every push: .github/workflows/githubci.yml, scripts/test_script.sh).
# `make ci` runs every lane; each lane is also callable alone.

.PHONY: ci lint analyze native-test tsan-test asan-test ubsan-test \
        parse-lanes telemetry trace cache range fsfault rig serving slo \
        device zerocopy pytest liveness elastic mesh bench-smoke dryrun doc \
        torch-lint torch-analyze torch-doc clean

ci: lint analyze native-test tsan-test asan-test ubsan-test parse-lanes \
    telemetry trace cache range fsfault rig serving slo device zerocopy \
    pytest liveness elastic mesh dryrun doc torch-lint torch-analyze torch-doc
	@echo "== all CI lanes green =="

asan-test:
	$(MAKE) -C cpp asan-test

# SIMD text-ingest lanes: benchparse correctness smoke + the --parse suite
# under ASan/TSan at every dispatch-tier override (cpp/Makefile)
parse-lanes:
	$(MAKE) -C cpp benchparse-check asan-parse tsan-parse

# Unified telemetry lane (doc/observability.md): the C++ registry suite
# under TSan (concurrent metric writers vs snapshot/reset walkers), then
# the full Python suite INCLUDING the slow-marked overhead guard that pins
# the instrumented parse path within 2% of DMLC_TELEMETRY=0 (CPU-time,
# interleaved A/B)
telemetry:
	$(MAKE) -C cpp tsan-telemetry
	python3 -m pytest tests/test_telemetry.py -q

# Distributed-tracing lane (doc/observability.md "Distributed tracing"):
# the C++ span-ring suite under TSan (ring wraparound, concurrent span
# writers vs snapshot/reset walkers, disabled-gate) plus the Python e2e —
# a real 2-subprocess-worker job scraped live at /trace and /metrics,
# SIGKILL flight-recorder dump, stall-attribution verdict flips. Hard
# timeout: a scrape that can hang the tracker is exactly the regression
# this lane exists to catch.
trace:
	$(MAKE) -C cpp tsan-trace
	timeout -k 10 300 python3 -m pytest tests/test_tracing.py -q

# Shard-cache lane (doc/caching.md): the C++ suite under BOTH sanitizers
# (concurrent readers during transcode, crash-recovery/corruption
# validation) plus the Python invalidation-edge + byte-identity matrix
# (all three text formats x both index widths, static and elastic
# iterators)
cache:
	$(MAKE) -C cpp asan-cache tsan-cache
	python3 -m pytest tests/test_shard_cache.py -q

# Parallel ranged-read lane (doc/io-ranged.md): the C++ engine suite under
# BOTH sanitizers (fetch workers racing the consumer, shutdown mid-flight,
# per-range retry isolation, 200-degrade) plus the Python live-backend
# matrix (byte-identity across all four mocks, Content-Range regression,
# degrade, knobs, observable concurrency speedup)
range:
	$(MAKE) -C cpp asan-range tsan-range
	python3 -m pytest tests/test_io_ranged.py -q

# Local-durability chaos lane (doc/robustness.md "Local durability"): the
# C++ fault-plan matrix under ASan (transcode/publish/replay under
# eio/enospc/short_write/fsync_fail/torn_rename — every outcome a clean
# miss, a valid replay, or a structured error) plus the Python gauntlet
# (checkpoint atomicity local+remote, event-log drop containment, SIGKILL
# sweep mid-transcode/publish). Hard timeout: a wedged pass is exactly
# the regression this lane exists to catch.
fsfault:
	$(MAKE) -C cpp asan-fsfault
	timeout -k 10 300 python3 -m pytest tests/test_fs_fault.py -q

# Device-lane observability (doc/observability.md "Device lane"): the
# CPU-backend floor of the always-measured device pipeline — span
# nesting on one clock, overlap ratio bounds, the extended stall-verdict
# matrix (stage/compile/transfer flips, injected e2e), compile-churn
# bucket census + clean replay, device_put failure flight dumps, and the
# bench device lane emitting numbers (device_unavailable is retired).
# Hard timeout: a hung backend session is exactly the regression this
# lane exists to catch. JAX_PLATFORMS=cpu pins the deterministic floor.
device:
	timeout -k 10 300 env JAX_PLATFORMS=cpu \
	  python3 -m pytest tests/test_device_observability.py -q

# Zero-copy ingest lane (doc/benchmarking.md "Zero-copy ingest"): staging
# buffers 64-byte aligned (pool reuse included), byte-identity of the
# zero-copy vs copying device paths for csr/dense x f32/bf16, fallback
# counter + recycle-skip gauge semantics, sharded placement on a forced
# multi-device CPU mesh, and the bf16.h <-> ml_dtypes parity fuzz (RNE
# ties, NaN quieting, subnormals, infinities) across the C/Python
# boundary. JAX_PLATFORMS=cpu pins the deterministic floor.
zerocopy:
	timeout -k 10 300 env JAX_PLATFORMS=cpu \
	  python3 -m pytest tests/test_zero_copy.py -q

# Measurement-rig lane (doc/benchmarking.md): out-of-process origin
# byte-identity against the in-process mocks for all four backends, a
# 5 s open-loop smoke at fixed QPS, the coordinated-omission pin
# (injected origin stall visible in intended-time p99, invisible in the
# naive service-time capture), and benchdiff against the seeded
# regression fixture (must exit nonzero) + a self-compare (must exit
# zero). Hard timeout: a wedged origin or generator is exactly the
# regression this lane exists to catch.
rig:
	timeout -k 10 300 python3 -m pytest tests/test_loadrig.py -q

# Online-scoring lane (doc/serving.md): the batched scoring server's
# correctness + robustness plane — forward math vs the trainers,
# keep-alive front end 4xx edges (431/405/411/413), bounded-queue /
# lateness-shed / breaker / draining degradation pins, bucket-padding
# compile census, payload-boundary fuzz (malformed/truncated/binary
# payloads, co-batch isolation), and the chaos gauntlet (fs faults on
# reload -> last-good, SIGKILL mid-traffic -> only clean outcomes,
# 2x-overload shed + admitted-p99 pin). JAX_PLATFORMS=cpu pins the
# deterministic floor; hard timeout because a wedged scorer or a
# never-draining shutdown is exactly the regression this lane catches.
serving:
	timeout -k 10 300 env JAX_PLATFORMS=cpu \
	  python3 -m pytest tests/test_serving.py tests/test_serving_fuzz.py \
	  tests/test_serving_chaos.py -q

# SLO-plane lane (doc/observability.md "SLO plane"): rolling-window
# rates/quantiles, multi-window burn-rate paging with hysteresis, and
# the burn e2e — an injected forward stall trips the fast burn within
# its knob-scaled window, flips /readyz, flight-dumps, and recovers.
# Hard timeout because a page that never clears (or a tick thread that
# never stops) is exactly the regression this lane exists to catch.
slo:
	timeout -k 10 300 env JAX_PLATFORMS=cpu \
	  python3 -m pytest tests/test_slo.py -q

lint:
	python3 scripts/lint.py

# Concurrency & invariant analysis (doc/analysis.md): the Python
# lock-discipline pass (blocking calls / re-acquisition under a held
# lock), the C++ DMLC_GUARDED_BY structural checker, the
# checked-env-parse / no-runtime-assert lints, and the cross-boundary
# contract passes — C-ABI/ctypes parity (builds + runs the compile-time
# struct layout probe; loud skip when no compiler is present), metric
# catalog, env-knob registry vs the generated doc/parameters.md table,
# wire-protocol words. Exit code = finding count.
analyze:
	python3 scripts/analyze.py

# gcc UndefinedBehaviorSanitizer lane (doc/analysis.md): the byte-load
# heavy suites (--parse/--cache/--telemetry) plus the deterministic
# shard-cache fuzz driver (--fuzz-shard), every finding fatal
ubsan-test:
	$(MAKE) -C cpp ubsan-test

# regenerates doc/api.md + doc/parameters.md from the live package; any
# undocumented public symbol fails the lane (the reference promotes doxygen
# warnings to errors, Makefile:93-97)
doc:
	python3 scripts/gendoc.py

# The PyTorch/H100 port's QA lane (dmlc_core_tpu_torch/qa/): the lint rules
# over the port's tree; the analyzer's passes over the port, its two C
# boundaries (cpp/src/capi.cc <-> io/native.py, csrc/*.cu <->
# ops/hopper_kernels.py) and its metric/knob contracts with the reference
# (exit code = finding count); doc/torch/ regenerated from the live port.
torch-lint:
	python3 -m dmlc_core_tpu_torch.qa.lint

torch-analyze:
	python3 -m dmlc_core_tpu_torch.qa.analyze

torch-doc:
	python3 -m dmlc_core_tpu_torch.qa.gendoc

# builds + runs the C++ unit binary (includes the big-endian golden-byte
# serializer tests -- the QEMU-free equivalent of the reference s390x lane)
native-test:
	$(MAKE) -C cpp testbin
	./dmlc_core_tpu/_native/test_core

tsan-test:
	$(MAKE) -C cpp tsan-test

pytest:
	python3 -m pytest tests/ -q

# distributed-job liveness chaos suite (doc/robustness.md): SIGKILL'd
# workers must recover (supervised) or abort the job within the deadline
# (unsupervised). The hard timeout makes a liveness regression a fast
# red instead of a hung CI job -- the exact failure mode the suite pins.
liveness:
	timeout -k 10 300 python3 -m pytest tests/test_tracker_liveness.py -q

# elastic data-plane chaos suite (doc/robustness.md "Elastic data-plane"):
# SIGKILL a lease-holding worker with no relaunch -- survivors must absorb
# its shards within the dead_after + grace bound and every worker set must
# replay the same seed-deterministic global stream. Hard timeout for the
# same reason as the liveness lane.
elastic:
	timeout -k 10 300 python3 -m pytest tests/test_elastic_data_plane.py -q

# elastic MESH chaos suite (doc/robustness.md "Elastic mesh training"):
# SIGKILL one rank of a real jax.distributed world mid-step. Supervised:
# the whole world relaunches from the last COMMITTED job checkpoint and
# every resumed loss matches the uninterrupted run. Unsupervised: every
# survivor exits with the structured abort code within 2x dead-after,
# wall-clock-asserted. Plus torn-commit refusal and the N-process vs
# single-process loss parity pin. JAX_PLATFORMS=cpu pins the
# deterministic floor; hard timeout for the same reason as liveness.
mesh:
	timeout -k 10 300 env JAX_PLATFORMS=cpu \
	  python3 -m pytest tests/test_elastic_mesh.py -q

dryrun:
	python3 -c "import __graft_entry__ as g; g.dryrun_multichip(8)"
	JAX_PLATFORMS=cpu python3 -c "import jax; \
	  jax.config.update('jax_platforms', 'cpu'); \
	  import __graft_entry__ as g; fn, args = g.entry(); \
	  jax.jit(fn).lower(*args).compile(); \
	  print('entry() compile-check OK')"

bench-smoke:
	python3 bench.py --smoke

clean:
	$(MAKE) -C cpp clean
