# WisecondorX-TPU container with JAX's CUDA 12 wheels; run it with the
# NVIDIA container runtime (docker run --gpus all ...).
FROM python:3.12-slim
RUN apt-get update && apt-get install -y --no-install-recommends \
    g++ make zlib1g-dev && rm -rf /var/lib/apt/lists/*
WORKDIR /opt/wisecondorx-tpu
COPY pyproject.toml README.md ./
COPY wisecondorx_tpu ./wisecondorx_tpu
COPY native ./native
RUN pip install --no-cache-dir '.[cuda,plot]' && make -C native
ENTRYPOINT ["wisecondorx-tpu"]
