# Container for riptrm_tpu (parity with the reference's Dockerfile, which
# ships a python:3 + pip environment; /root/reference/Dockerfile:1-18).
# For NVIDIA GPU runs install the CUDA build of JAX instead:
#   pip install "jax[cuda12]"
FROM python:3.12

WORKDIR /app
COPY pyproject.toml ./
RUN pip install --no-cache-dir "jax[cpu]" numpy scipy pandas matplotlib seaborn pyyaml pytest wandb
COPY . .

CMD ["/bin/bash"]
