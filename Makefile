# Developer entry points (the reference's devenv.nix scripts analog).

PY ?= python

.PHONY: test test-fast lint native bench suite smoke clean

test:
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
		$(PY) -m pytest tests/ -q

test-fast:
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
		$(PY) -m pytest tests/ -q -x -k "not sharded and not streaming"

native:
	$(PY) -c "import metrovector_tpu.native as n; assert n.available(); print('native codec OK')"

bench:
	$(PY) bench.py

suite:
	$(PY) benchmarks/suite.py

smoke:
	$(PY) chip_smoke.py

clean:
	rm -rf .native_build
	find . -name __pycache__ -type d -exec rm -rf {} +
