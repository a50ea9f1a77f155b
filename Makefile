# spintorque-tpu development targets (counterpart of the reference Makefile).

PY := python
# CPU test env: the CPU backend with 8 virtual devices (tests/conftest.py).
TEST_ENV := env JAX_PLATFORMS=cpu

.PHONY: test test-fast test-parity test-gpu smoke bench train info lint clean \
        docker-build docker-test docker-train docker-bench

test:
	$(TEST_ENV) $(PY) -m pytest tests/ -x -q

test-fast:
	$(TEST_ENV) $(PY) -m pytest tests/unit -x -q

test-parity:
	$(TEST_ENV) $(PY) -m pytest tests/parity -x -q

# On a GPU host: the gpu-marked tests.
test-gpu:
	env SPINTORQUE_TEST_PLATFORM=gpu $(PY) -m pytest tests/ -m gpu -q

smoke:
	$(PY) chip_smoke.py

bench:
	$(PY) bench.py

train:
	$(PY) -m spintorque_tpu.cli train --timesteps 100000

info:
	$(PY) -m spintorque_tpu.cli info

lint:
	$(PY) -m compileall -q spintorque_tpu tests bench.py chip_smoke.py __graft_entry__.py

clean:
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true

# Container targets (counterpart of the reference Makefile's docker tier).
docker-build:
	./deploy.sh build

docker-test:
	./deploy.sh test

docker-train:
	docker compose --profile train up -d

docker-bench:
	docker compose --profile bench run --rm bench
