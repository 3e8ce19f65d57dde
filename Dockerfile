# Build/test image for real_time_ray_tracing_engine_tpu.
#
# Ops-parity analogue of the reference's CUDA devel image
# (/root/reference/Dockerfile: nvidia/cuda:12.2.0-devel-ubuntu22.04 + SDL
# deps): here the device stack is JAX with its CUDA 12 wheel, which runs the
# path tracer on an NVIDIA GPU; the tests run on its CPU backend and the
# 8-device virtual mesh of tests/conftest.py.
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ make cmake ninja-build git \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/rtx
COPY pyproject.toml README.md bench.py chip_smoke.py ./
COPY real_time_ray_tracing_engine_tpu ./real_time_ray_tracing_engine_tpu
COPY scripts ./scripts
COPY tests ./tests

RUN pip install --no-cache-dir "jax[cuda12]" optax chex pytest \
    && pip install --no-cache-dir -e .

# native helpers (BVH builder, PPM encoder); falls back to numpy if absent
RUN bash scripts/build_native.sh || true

CMD ["python", "-m", "pytest", "tests/", "-q"]
