# Developer entry points (reference Makefile parity: check/test/run targets).

PY ?= python

.PHONY: check test test-full slt bench smoke tpch tpch_distributed run native planner_test planner_test_build clean

check: native test-full slt

test:
	$(PY) -m pytest tests/ -q

test-full:
	$(PY) -m pytest tests/ -q -m ""

slt:
	$(PY) -m tests.slt_runner

planner_test:
	$(PY) -m pytest tests/test_optimizer.py -q

# regenerate the checked-in plan-golden snapshots (reference parity:
# `make planner_test_build`, reference Makefile:15-19)
planner_test_build:
	$(PY) -m tests.plan_goldens --apply

bench:
	$(PY) bench.py

smoke:
	$(PY) chip_smoke.py

# TPC-H (reference Makefile:46-70 only scaffolds dbgen; here the suite RUNS):
# all 22 queries over dbgen-faithful generated data, checked against pandas
# oracles. SF=0.01 finishes in minutes on CPU; `make smoke` checks six
# queries at SF1 on the GPU.
TPCH_SF ?= 0.01
tpch:
	$(PY) -m benchmarks.tpch --sf $(TPCH_SF) --check --repeat 2

tpch_distributed:
	$(PY) -m benchmarks.tpch --sf $(TPCH_SF) --check --repeat 1 --devices 8

run:
	$(PY) -m sqlrs_tpu.cli --csv-dir tests/csv

native:
	$(MAKE) -C native

clean:
	$(MAKE) -C native clean
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
