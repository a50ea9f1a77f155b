#!/usr/bin/env bash
# Deployment driver (counterpart of the reference's deploy.sh):
# builds the container, runs the CPU test gate, and either starts the local
# compose stack or emits the per-host launch commands for a multi-host GPU
# run (generated by spintorque_tpu.deployment.DeploymentSpec).
#
# Usage:
#   ./deploy.sh build                 # docker image (builder stage = test gate)
#   ./deploy.sh test                  # full CPU suite in the dev image
#   ./deploy.sh up                    # local compose train stack
#   ./deploy.sh pod <hosts> <coord>   # print multi-host launch commands
set -euo pipefail

IMAGE=${IMAGE:-spintorque-tpu}
TAG=${TAG:-$(git rev-parse --short HEAD 2>/dev/null || echo latest)}

case "${1:-help}" in
  build)
    docker build --target runtime -t "$IMAGE:$TAG" -t "$IMAGE:latest" .
    ;;
  test)
    docker build --target dev -t "$IMAGE:dev" .
    docker run --rm -e JAX_PLATFORMS=cpu \
      -e XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      "$IMAGE:dev" make test
    ;;
  up)
    docker compose --profile train up -d
    ;;
  down)
    docker compose --profile train down
    ;;
  pod)
    HOSTS=${2:?usage: deploy.sh pod <num_hosts> <coordinator_address>}
    COORD=${3:?usage: deploy.sh pod <num_hosts> <coordinator_address>}
    python - "$HOSTS" "$COORD" <<'PY'
import sys
from spintorque_tpu.deployment import DeploymentSpec
spec = DeploymentSpec(name="pod", num_hosts=int(sys.argv[1]))
for cmd in spec.launch_commands(sys.argv[2]):
    print(cmd)
PY
    ;;
  *)
    grep '^#   ' "$0" | sed 's/^#   //'
    ;;
esac
