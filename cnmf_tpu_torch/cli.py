"""Command-line interface — flag-for-flag the JAX package's (cnmf_tpu/cli.py,
itself compatible with reference cnmf.py:1213-1298): ``cnmf-tpu-torch
{prepare,factorize,combine,consensus,k_selection_plot}`` with the same 19
flags and defaults, on the port's ``cNMF``.

Every stage runs on the CUDA card; ``CNMF_TPU_PLATFORM=cpu`` (the JAX CLI's
knob) runs it on the CPU instead. ``warmup`` (the JAX package's compile-cache
warm-up) is accepted so scripts written for that CLI still run, and does
nothing: the port has no compiler cache to fill.

    python -m cnmf_tpu_torch.cli prepare --output-dir out --name run \\
        -c counts.h5ad -k 5 6 7 -n 100 --seed 14
"""

from __future__ import annotations

import argparse
import os

from cnmf_tpu_torch.io.dataframe import load_df_from_npz
from cnmf_tpu_torch.pipeline.cnmf import cNMF


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="cnmf-tpu-torch")
    parser.add_argument(
        "command", type=str,
        choices=["prepare", "factorize", "combine", "consensus",
                 "k_selection_plot", "warmup"],
    )
    parser.add_argument("--name", type=str, nargs="?", default="cNMF",
                        help="[all] Name for analysis. All output will be placed in [output-dir]/[name]/...")
    parser.add_argument("--output-dir", type=str, nargs="?", default=".",
                        help="[all] Output directory. All output will be placed in [output-dir]/[name]/...")
    parser.add_argument("-c", "--counts", type=str,
                        help="[prepare] Input (cell x gene) counts matrix as .h5ad, .mtx, df.npz, or tab delimited text file")
    parser.add_argument("-k", "--components", type=int, nargs="+",
                        help='[prepare] Number of components (k) for matrix factorization. Several can be specified with "-k 8 9 10"')
    parser.add_argument("-n", "--n-iter", type=int, default=100,
                        help="[prepare] Number of factorization replicates")
    parser.add_argument("--total-workers", type=int, default=1,
                        help="[all] Total number of workers to distribute jobs to")
    parser.add_argument("--seed", type=int, default=None,
                        help="[prepare] Seed for pseudorandom number generation")
    parser.add_argument("--genes-file", type=str, default=None,
                        help="[prepare] File containing a list of genes to include, one gene per line. Must match column labels of counts matrix.")
    parser.add_argument("--numgenes", type=int, default=2000,
                        help="[prepare] Number of high variance genes to use for matrix factorization.")
    parser.add_argument("--tpm", type=str, default=None,
                        help="[prepare] Pre-computed (cell x gene) TPM values as df.npz or tab separated txt file. If not provided TPM will be calculated automatically")
    parser.add_argument("--max-nmf-iter", type=int, default=1000,
                        help="[prepare] Max number of iterations per individual NMF run (default 1000)")
    parser.add_argument("--beta-loss", type=str, default="frobenius",
                        choices=["frobenius", "kullback-leibler", "itakura-saito"],
                        help="[prepare] Loss function for NMF (default frobenius)")
    parser.add_argument("--init", type=str, default="random",
                        choices=["random", "nndsvd"],
                        help="[prepare] Initialization algorithm for NMF (default random)")
    parser.add_argument("--densify", dest="densify", action="store_true", default=False,
                        help="[prepare] Treat the input data as non-sparse (default False)")
    parser.add_argument("--worker-index", type=int, default=0,
                        help="[factorize] Index of current worker (the first worker should have index 0)")
    parser.add_argument("--skip-completed-runs", action="store_true", default=False,
                        help="[factorize] Skip previously completed runs. Must re-run prepare first to update completed runs")
    parser.add_argument("--local-density-threshold", type=float, default=0.5,
                        help="[consensus] Threshold for the local density filtering. This string must convert to a float >0 and <=2")
    parser.add_argument("--local-neighborhood-size", type=float, default=0.30,
                        help="[consensus] Fraction of the number of replicates to use as nearest neighbors for local density filtering")
    parser.add_argument("--show-clustering", dest="show_clustering", action="store_true",
                        help="[consensus] Produce a clustergram figure summarizing the spectra clustering")
    parser.add_argument("--build-reference", dest="build_reference", action="store_true", default=True,
                        help="[consensus] Generates a reference spectra for use in starCAT")
    return parser


def cli_device() -> str:
    """The device of a CLI run: "cpu" when CNMF_TPU_PLATFORM is "cpu", else
    the CUDA card."""
    return "cpu" if os.environ.get("CNMF_TPU_PLATFORM") == "cpu" else "cuda"


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.command == "warmup":
        print("warmup: nothing to do — the PyTorch port builds its kernels "
              "on first use and has no compile cache to fill")
        return
    cnmf_obj = cNMF(output_dir=args.output_dir, name=args.name,
                    device=cli_device())

    if args.command == "prepare":
        cnmf_obj.prepare(
            args.counts, components=args.components, n_iter=args.n_iter,
            densify=args.densify, tpm_fn=args.tpm, seed=args.seed,
            beta_loss=args.beta_loss, max_NMF_iter=args.max_nmf_iter,
            num_highvar_genes=args.numgenes, genes_file=args.genes_file,
            init=args.init,
        )
    elif args.command == "factorize":
        cnmf_obj.factorize(
            worker_i=args.worker_index, total_workers=args.total_workers,
            skip_completed_runs=args.skip_completed_runs,
        )
    elif args.command == "combine":
        cnmf_obj.combine(components=args.components)
    elif args.command == "consensus":
        run_params = load_df_from_npz(cnmf_obj.paths["nmf_replicate_parameters"])
        if type(args.components) is int:
            ks = [args.components]
        elif args.components is None:
            ks = sorted(set(run_params.n_components))
        else:
            ks = args.components
        for k in ks:
            cnmf_obj.consensus(
                k, args.local_density_threshold, args.local_neighborhood_size,
                args.show_clustering, args.build_reference,
                close_clustergram_fig=True,
            )
    elif args.command == "k_selection_plot":
        cnmf_obj.k_selection_plot(close_fig=True)


if __name__ == "__main__":
    main()
