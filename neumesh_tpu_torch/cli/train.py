"""Training CLI (counterpart of the repository's train.py).

    python -m neumesh_tpu_torch.cli.train --config <yaml> \\
        [--section:key value ...] [--device cpu]
    python -m neumesh_tpu_torch.cli.train --resume_dir logs/<expname>

Trains the config's framework (NeuS, or NeuMesh distilled from the NeuS
teacher its config names) on the card unless --device cpu is given;
without a card and without that flag it raises. Logs, images and
checkpoints go to <training.log_root_dir>/<expname>/, as train.py writes
them.

Data parallel, one process per GPU (each rank on its cuda:LOCAL_RANK):

    torchrun --nproc_per_node=<G> -m neumesh_tpu_torch.cli.train \
        --config <yaml> [--section:key value ...]
    torchrun --nnodes=<N> --node_rank=<i> --nproc_per_node=<G> \
        --master_addr=<host 0> --master_port=<port> \
        -m neumesh_tpu_torch.cli.train --config <yaml>
    srun --ntasks=<N x G> --ntasks-per-node=<G> \
        python -m neumesh_tpu_torch.cli.train --config <yaml> [--port P]

Each update takes data.batch_size images per host and splits each
image's data.N_rays rays over the host's GPUs; it equals one
single-process update on the N x batch_size images (train/loop.py).
"""
from __future__ import annotations

from ..config import create_args_parser, load_config
from ..train.loop import main_function
from ..utils.print_fn import init_log


def main(argv=None):
    parser = create_args_parser()
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device to train on; 'cpu' runs the kernels' plain "
             "versions (tests)")
    args, unknown = parser.parse_known_args(argv)
    return main_function(load_config(args, unknown))


if __name__ == "__main__":
    init_log()
    main()
