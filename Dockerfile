# spintorque-tpu container image.
#
# GPU-first counterpart of the reference's Dockerfile (multi-stage build,
# non-root runtime, healthcheck). The runtime stage targets NVIDIA GPU hosts:
# jax[cuda12] bundles the CUDA runtime; on a host without a GPU the same
# image falls back to the CPU backend automatically (JAX picks the best
# available platform), so one image serves dev, CI, and GPU hosts.

# ---------------------------------------------------------------------------
# builder: wheel build + unit-test gate
# ---------------------------------------------------------------------------
FROM python:3.12-slim AS builder

ENV PYTHONUNBUFFERED=1 \
    PYTHONDONTWRITEBYTECODE=1 \
    PIP_NO_CACHE_DIR=1 \
    PIP_DISABLE_PIP_VERSION_CHECK=1

WORKDIR /build
RUN pip install --upgrade pip build

COPY pyproject.toml README.md ./
COPY spintorque_tpu ./spintorque_tpu
RUN python -m build --wheel --outdir /build/dist

# the fast unit tier must pass before an image is produced
COPY tests ./tests
COPY Makefile bench.py __graft_entry__.py ./
RUN pip install dist/*.whl "jax[cpu]" pytest gymnasium optax orbax-checkpoint chex einops \
 && env JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python -m pytest tests/unit -x -q

# ---------------------------------------------------------------------------
# runtime: minimal non-root image for GPU hosts (and CPU fallback)
# ---------------------------------------------------------------------------
FROM python:3.12-slim AS runtime

LABEL org.opencontainers.image.title="spintorque-tpu" \
      org.opencontainers.image.description="Spin-torque device RL environment engine on the GPU"

ENV PYTHONUNBUFFERED=1 \
    PYTHONDONTWRITEBYTECODE=1 \
    PIP_NO_CACHE_DIR=1

RUN groupadd -r spintorque && useradd -r -g spintorque -m spintorque

COPY --from=builder /build/dist/*.whl /tmp/
# The CUDA wheel runs on the CPU backend where no GPU is visible.
RUN pip install /tmp/*.whl gymnasium optax orbax-checkpoint chex einops \
 && pip install "jax[cuda12]" \
 && rm -rf /tmp/*.whl

WORKDIR /app
RUN mkdir -p checkpoints results logs && chown -R spintorque:spintorque /app
USER spintorque
VOLUME ["/app/checkpoints", "/app/results", "/app/logs"]

# serving-health probe drives the real package (deployment/manager.py)
HEALTHCHECK --interval=60s --timeout=30s --start-period=120s --retries=3 \
    CMD python -c "from spintorque_tpu.deployment import serving_health; \
import sys; sys.exit(0 if serving_health()['status'] == 'HEALTHY' else 1)"

ENTRYPOINT ["python", "-m", "spintorque_tpu.cli"]
CMD ["info"]

# ---------------------------------------------------------------------------
# dev: runtime + test/lint tooling and the full source tree
# ---------------------------------------------------------------------------
FROM runtime AS dev
USER root
RUN pip install pytest ruff
COPY --chown=spintorque:spintorque . /app
USER spintorque
ENTRYPOINT []
CMD ["bash"]
