"""Offline model-evaluation CLI: ``python -m seqrec_tpu_torch.cli.test``.

Same protocol and flags as ``seqrec_tpu/cli/test.py`` (per test user, feed
the first half of the sequence, goal = item ids of the second half; epoch
selection with ``-i`` or glob-all-models, resume-skip of already-tested
epochs via the results-file tail, metric printing and TSV appending, and
the ``--save_rank`` full rank dump, written with ``--save`` beside the
results file as ``..._full_rank``), plus ``--device {cuda,cuda:N,cpu}``.
It runs on CUDA unless ``--device cpu`` is given. ``--mesh`` evaluates
over a ("data", "model") mesh of ranks (``cli/train.py``'s flag, launched
by torchrun the same way) for the models that take one in training, and
for BPRMF, FPMC, FISM and Fossil; the rank with ``LOCAL_RANK`` 0 writes
the results files.
"""

from __future__ import annotations

import glob
import os
import re
import sys
import time

import numpy as np

import seqrec_tpu_torch.utils.command_parser as parse
from seqrec_tpu_torch import resolve_device
from seqrec_tpu_torch.cli.train import device_arg, make_cli_mesh
from seqrec_tpu_torch.data import DataHandler
from seqrec_tpu_torch.parallel.distributed import writes_files
from seqrec_tpu_torch.utils import evaluation


def get_file_name(predictor, args):
    return args.dir + re.sub(
        "_ml" + str(args.max_length),
        "_ml" + str(args.training_max_length),
        predictor._get_model_filename(args.number_of_batches),
    )


def find_models(predictor, dataset, args):
    if args.method in ("UKNN", "MM", "POP"):
        return None
    file = dataset.dirname + "models/" + get_file_name(predictor, args)
    if args.number_of_batches == "*":
        matches = glob.glob(file)
        # the ``ne*`` wildcard must capture ONLY the epoch number. The
        # reference's filename scheme omits defaulted config tokens
        # (e.g. the LSTM tower marker, recurrent_layers.py name), so a
        # default-config glob like ``..._ne*_gc100_...`` also swallows
        # ``..._ne1.09_GRU_gc100_...`` — loading a DIFFERENT family's
        # checkpoint (observed: GRU params into an LSTM apply ->
        # KeyError 'c0'). Keep a match only if the captured field
        # parses as a plain epoch float.
        base = get_file_name(predictor, args).replace("\\", "/").split("/")[-1]
        pattern = re.compile(
            re.escape(base).replace(
                re.escape("ne*"), r"ne([0-9]+(\.[0-9]+)?)"
            )
            + r"$"
        )
        matches = [
            f for f in matches if pattern.search(f.replace("\\", "/").split("/")[-1])
        ]
        file = np.array(matches)
    return file


def save_file_name(predictor, dataset, args):
    if not args.save:
        return None
    return re.sub(
        r"_ne\*_", "_", dataset.dirname + "results/" + get_file_name(predictor, args)
    )


def run_tests(predictor, model_file, dataset, args, get_full_recommendation_list=False, k=10):
    predictor.load(model_file)
    if hasattr(predictor, "set_dataset"):
        predictor.set_dataset(dataset)
    evaluator = evaluation.Evaluator(dataset, k=k)
    if get_full_recommendation_list:
        k = dataset.n_items

    nb_of_dp = []
    start = time.perf_counter()

    # Batched evaluation when the predictor supports it (RNN family);
    # falls back to the reference's per-user loop otherwise.
    batched = hasattr(predictor, "_iter_test_instances") and args.clusters <= 0
    if batched:
        # the test inputs are identical for every model file in the
        # epoch glob: encode + upload them once and reuse the
        # device-resident chunks across the whole model loop (only the
        # parameters change between files). Disabled when
        # --rand_test_target makes the goals non-deterministic.
        cacheable = getattr(
            getattr(predictor, "target_selection", None), "determinist_test", False
        )
        cache = getattr(predictor, "_test_stage_cache", None)
        if not cacheable or cache is None or cache[0] is not dataset:
            instances = list(
                predictor._iter_test_instances(dataset.test_set(epochs=1))
            )
            inputs = [seq for seq, _, _ in instances]
            staged = (
                predictor._stage_eval_inputs(
                    inputs, user_ids=[u for _, _, u in instances]
                )
                if inputs
                else []
            )
            if cacheable:
                predictor._test_stage_cache = (dataset, instances, staged)
        else:
            _, instances, staged = cache
        if instances:
            recs = predictor._topk_from_staged(staged, k=k)
            for (_, goal, _), rec in zip(instances, recs):
                if len(goal) == 0:
                    raise ValueError
                evaluator.add_instance(goal, rec.tolist())
    else:
        viewed_list, user_ids, goals = [], [], []
        for sequence, user_id in dataset.test_set(epochs=1):
            num_viewed = int(len(sequence) / 2)
            viewed_list.append(sequence[:num_viewed])
            user_ids.append(user_id)
            goals.append([i[0] for i in sequence[num_viewed:]])
            if len(goals[-1]) == 0:
                raise ValueError
        if args.clusters > 0 and hasattr(predictor, "top_k_batch_clustered"):
            # one device pass for every user's cluster assignment, then
            # one matmul per cluster (cluster.py:top_k_batch_clustered)
            recs, ns = predictor.top_k_batch_clustered(
                viewed_list, k=k, user_ids=user_ids
            )
            nb_of_dp.extend(ns)
            for goal, recommendations in zip(goals, recs):
                evaluator.add_instance(goal, recommendations)
        elif args.clusters <= 0 and hasattr(predictor, "top_k_batch"):
            # MF/LTM vectorized whole-matrix scoring
            recs = predictor.top_k_batch(
                list(zip(viewed_list, user_ids)), k=k
            )
            for goal, recommendations in zip(goals, recs):
                evaluator.add_instance(goal, list(recommendations))
        else:
            for viewed, user_id, goal in zip(viewed_list, user_ids, goals):
                if args.clusters > 0:
                    recommendations, n = predictor.top_k_recommendations(
                        viewed, user_id=user_id, k=k
                    )
                    nb_of_dp.append(n)
                else:
                    recommendations = predictor.top_k_recommendations(
                        viewed, user_id=user_id, k=k
                    )
                evaluator.add_instance(goal, recommendations)
    print("Timer: ", time.perf_counter() - start)
    if len(nb_of_dp) == 0:
        evaluator.nb_of_dp = dataset.n_items
    else:
        evaluator.nb_of_dp = np.mean(nb_of_dp)
    return evaluator


def print_results(ev, metrics, plot=True, file=None, n_batches=None, print_full_rank_comparison=False):
    for m in metrics:
        if m not in ev.metrics:
            raise ValueError("Unknown metric: " + m)
        print(m + "@" + str(ev.k) + ": ", ev.metrics[m]())

    if file is not None:
        if os.path.dirname(file) and not os.path.exists(os.path.dirname(file)):
            os.makedirs(os.path.dirname(file))
        with open(file, "a") as f:
            # NB: the reference omits the tab between the epoch count and the
            # first metric (test.py:91), which breaks its own resume-skip
            # float parse; we emit a well-formed TSV row instead.
            f.write(
                str(n_batches)
                + "\t"
                + "\t".join(map(str, [ev.metrics[m]() for m in metrics]))
                + "\n"
            )
        if print_full_rank_comparison:
            with open(file + "_full_rank", "a") as f:
                for data in ev.get_rank_comparison():
                    f.write("\t".join(map(str, data)) + "\n")
    else:
        print(
            "-\t" + "\t".join(map(str, [ev.metrics[m]() for m in metrics])),
            file=sys.stderr,
        )


def extract_number_of_epochs(filename):
    m = re.search(r"_ne([0-9]+(\.[0-9]+)?)_", filename)
    return float(m.group(1))


def get_last_tested_batch(filename):
    if filename is not None and os.path.isfile(filename):
        line = None
        with open(filename) as f:
            for line in f:
                pass
        if line:
            return float(line.split()[0])
    return 0


def test_command_parser(parser):
    parser.add_argument(
        "-d", dest="dataset", help="Directory name of the dataset.", default="", type=str
    )
    parser.add_argument(
        "-i",
        dest="number_of_batches",
        help="Number of epochs; unset compares all available models",
        default=-1,
        type=int,
    )
    parser.add_argument(
        "-k",
        dest="nb_of_predictions",
        help='The "k" in prec@k, rec@k, etc.',
        default=10,
        type=int,
    )
    parser.add_argument(
        "--metrics",
        help="Metrics to compute, comma separated",
        default="sps,recall,item_coverage,user_coverage,blockbuster_share",
        type=str,
    )
    parser.add_argument("--save", help="Save results to a file", action="store_true")
    parser.add_argument("--dir", help="Model directory.", default="", type=str)
    parser.add_argument(
        "--save_rank",
        help="Save the full goal/prediction rank comparison.",
        action="store_true",
    )
    parser.add_argument(
        "--mesh",
        help='Shard batched evaluation over a ("data","model") device mesh '
        '("DATA,MODEL" or "auto"); same semantics as train.py --mesh.',
        default="",
        type=str,
    )
    parser.add_argument(
        "--device",
        type=device_arg,
        help="Device to evaluate on (cuda, cuda:N or cpu); cuda raises when no GPU is present. Under --mesh, "
        "cuda is cuda:LOCAL_RANK.",
        default="cuda",
    )


def main(argv=None):
    """Run the CLI; returns the evaluator of the last model tested."""
    args = parse.command_parser(
        parse.predictor_command_parser, test_command_parser, argv=argv
    )
    args.training_max_length = args.max_length
    if args.number_of_batches == -1:
        args.number_of_batches = "*"
    mesh = make_cli_mesh(args.mesh, args.device) if args.mesh else None
    if mesh is not None:
        args.device = str(mesh.device)
    resolve_device(args.device)

    dataset = DataHandler(dirname=args.dataset)
    predictor = parse.get_predictor(args)
    predictor.prepare_model(dataset)
    if mesh is not None:
        if not hasattr(predictor, "set_mesh"):
            raise ValueError(
                f"--mesh is supported for the RNN/SDAE/cluster families; {predictor.name!r} evaluates single-device"
            )
        predictor.set_mesh(mesh)
    file = find_models(predictor, dataset, args)
    # ranks on one host would race on the results files
    writes = writes_files()

    evaluator = None
    if args.number_of_batches == "*" and args.method not in ("UKNN", "MM", "POP"):
        output_file = save_file_name(predictor, dataset, args) if args.save else None
        last_tested_batch = get_last_tested_batch(output_file)
        batches = np.array([extract_number_of_epochs(f) for f in file])
        sorted_ids = np.argsort(batches)
        batches = batches[sorted_ids]
        file = file[sorted_ids]
        for i, f in enumerate(file):
            if batches[i] > last_tested_batch:
                evaluator = run_tests(
                    predictor,
                    f,
                    dataset,
                    args,
                    get_full_recommendation_list=args.save_rank,
                    k=args.nb_of_predictions,
                )
                print("-------------------")
                print("(", i + 1, "/", len(file), ") results on " + f)
                print_results(
                    evaluator,
                    args.metrics.split(","),
                    plot=False,
                    file=output_file if writes else None,
                    n_batches=batches[i],
                    print_full_rank_comparison=args.save_rank,
                )
    else:
        evaluator = run_tests(
            predictor,
            file,
            dataset,
            args,
            get_full_recommendation_list=args.save_rank,
            k=args.nb_of_predictions,
        )
        print_results(
            evaluator,
            args.metrics.split(","),
            file=save_file_name(predictor, dataset, args) if args.save and writes else None,
            print_full_rank_comparison=args.save_rank,
        )
    return evaluator


if __name__ == "__main__":
    try:
        main()
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
