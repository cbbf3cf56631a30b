"""Job specs for NVIDIA H100 nodes: the port's counterpart of the JAX
package's `scripts/generate_tpu_jobs.py`, with its modes and its one GKE
JobSet YAML per (checkpoint, mode), running the port's CLI.

    python -m bitdistiller_tpu_torch.scripts.generate_gpu_jobs \\
        --checkpoints /ckpts/llama-2-7b --modes autoclip train ppl

Modes: train (KD-QAT over every card of `num_hosts` nodes), autoclip,
eval_tasks, eval_gsm8k, ppl and serve. `train` is the one multi-rank mode:
each node starts one process a card, and the job sets the rendezvous that
`bitdistiller_tpu_torch.parallel.distributed.init_distributed` reads from
the environment as torchrun's (MASTER_ADDR and MASTER_PORT on node 0,
WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE). The others run one process
on one card; `serve` is the CLI's `chat` on a packed checkpoint, as in the
TPU spec (the port's CLI serves from one process: a mesh engine is the
library's `Engine(..., mesh=)`). Each job asks for `nvidia.com/gpu` where
the TPU spec asks for a slice.
"""

from __future__ import annotations

import argparse
import os
import re

JOB_TEMPLATE = """\
apiVersion: jobset.x-k8s.io/v1alpha2
kind: JobSet
metadata:
  name: {name}
spec:
  replicatedJobs:
  - name: workers
    replicas: {num_hosts}
    template:
      spec:
        parallelism: 1
        completions: 1
        template:
          spec:
            nodeSelector:
              cloud.google.com/gke-accelerator: {accelerator}
            containers:
            - name: main
              image: {image}
              resources:
                limits:
                  nvidia.com/gpu: {gpus}
{env}              command: ["bash", "-c"]
              args:
              - |
                cd /workspace/bitdistiller-tpu
{command}
"""

ENV_ITEM = "              - name: {name}\n                value: \"{value}\""
# a node's index in its JobSet, from the label JobSet sets on each pod
NODE_RANK_ITEM = ("              - name: NODE_RANK\n"
                  "                valueFrom:\n"
                  "                  fieldRef:\n"
                  "                    fieldPath: metadata.labels['jobset.sigs.k8s.io/job-index']")
MASTER_PORT = 29500
CLI = "python -m bitdistiller_tpu_torch.cli"

MODES = {
    "train": (
        CLI + " train "
        "--model_name_or_path {model} --data_path {data} "
        "--output_dir {out}/train_{tag} --bits {bits} --q_group_size {group} "
        "--quant_type {quant_type} --clip {out}/clip_{tag}.npz "
        "--kd_loss_type cakld --per_device_train_batch_size 2 "
        "--gradient_accumulation_steps 8 --learning_rate 8e-6"
    ),
    "autoclip": (
        CLI + " autoclip --model_path {model} "
        "--w_bit {bits} --q_group_size {group} --dump_clip {out}/clip_{tag}.npz"
    ),
    "eval_tasks": (
        CLI + " eval --model_path {model} "
        "--tasks mmlu,arc_challenge,winogrande,hellaswag,piqa "
        "--quant_type int --w_bit {bits} --q_group_size {group}"
    ),
    "eval_gsm8k": CLI + " gsm8k --model_path {model} --data_path {data}",
    "ppl": (
        CLI + " ppl --model_path {model} "
        "--quant_type int --w_bit {bits} --q_group_size {group}"
    ),
    "serve": CLI + " chat --model_path {model} --load_quant {out}/packed_{tag}",
}
MULTI_RANK = ("train",)
INDENT = " " * 16


def ranks(mode: str, args) -> tuple[int, int]:
    """(nodes, cards a node) of a mode's job."""
    if mode in MULTI_RANK:
        return args.num_hosts, args.gpus_per_host
    return 1, 1


def command_lines(mode: str, cmd: str, name: str, args) -> tuple[str, str]:
    """The container's env block and its shell lines: one process, or one
    a card of every node with the rendezvous exported before each starts."""
    hosts, gpus = ranks(mode, args)
    if hosts * gpus == 1:
        return "", INDENT + cmd
    env = ["              env:",
           ENV_ITEM.format(name="MASTER_ADDR", value=f"{name}-workers-0-0.{name}"),
           ENV_ITEM.format(name="MASTER_PORT", value=MASTER_PORT),
           ENV_ITEM.format(name="WORLD_SIZE", value=hosts * gpus),
           ENV_ITEM.format(name="LOCAL_WORLD_SIZE", value=gpus), NODE_RANK_ITEM]
    lines = [f"for LOCAL_RANK in $(seq 0 {gpus - 1}); do",
             "  export LOCAL_RANK RANK=$((NODE_RANK * LOCAL_WORLD_SIZE + LOCAL_RANK))",
             "  " + cmd + " &",
             "done",
             "wait"]
    return "\n".join(env) + "\n", "\n".join(INDENT + line for line in lines)


def generate(args) -> list[str]:
    os.makedirs(args.out_dir, exist_ok=True)
    paths = []
    for ckpt in args.checkpoints:
        # K8s object names must be DNS-1123 labels: lowercase alnum + '-'
        tag = re.sub(r"[^a-z0-9-]+", "-", os.path.basename(ckpt.rstrip("/")).lower()).strip("-")
        for mode in args.modes:
            cmd = MODES[mode].format(
                model=ckpt, data=args.data_path, out=args.artifact_dir,
                tag=tag, bits=args.bits, group=args.group_size,
                quant_type=args.quant_type,
            )
            name = f"bdg-{mode.replace('_', '-')}-{tag}"[:52]
            hosts, gpus = ranks(mode, args)
            env, command = command_lines(mode, cmd, name, args)
            yaml_text = JOB_TEMPLATE.format(
                name=name, num_hosts=hosts, accelerator=args.accelerator, image=args.image,
                gpus=gpus, env=env, command=command,
            )
            path = os.path.join(args.out_dir, f"{mode}_{tag}.yaml")
            with open(path, "w") as f:
                f.write(yaml_text)
            paths.append(path)
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(prog="generate_gpu_jobs")
    ap.add_argument("--checkpoints", nargs="+", required=True)
    ap.add_argument("--modes", nargs="+", default=["autoclip", "train", "ppl"],
                    choices=sorted(MODES))
    ap.add_argument("--out_dir", default="jobs")
    ap.add_argument("--artifact_dir", default="/artifacts")
    ap.add_argument("--data_path", default="/data/teacher.jsonl")
    ap.add_argument("--bits", type=int, default=2)
    ap.add_argument("--group_size", type=int, default=128)
    ap.add_argument("--quant_type", default="int2-asym")
    ap.add_argument("--image", default="bitdistiller-tpu:latest")
    ap.add_argument("--accelerator", default="nvidia-h100-80gb")
    ap.add_argument("--num_hosts", type=int, default=2)
    ap.add_argument("--gpus_per_host", type=int, default=8)
    args = ap.parse_args(argv)
    for p in generate(args):
        print(p)


if __name__ == "__main__":
    main()
