"""One rank of a CPU gloo group for the port's gradient-compression tests.

    python tests/torch_dist_worker.py CASE RANK WORLD STORE_FILE OUT_NPZ

Joins a ``torch.distributed`` gloo group through a ``FileStore`` (no
network), runs ``compressed_psum_tree`` on this rank's inputs (made from a
seed with numpy, by the builders below, which the tests import to feed the
JAX package the same trees) and writes every output leaf to ``OUT_NPZ`` as
``<codec>/<mean|res>/<leaf key>``.  Not a test file: the tests start it,
one process per rank.
"""
import sys

import numpy as np

FEEDBACK_BITS = 12
PARITY_CODECS = ("fr8", "fr16", "fa1e-3")


def feedback_tree(rank: int) -> dict:
    """test_tree_codec's two-device tree: ``g`` on rank 0, ``-g`` on rank
    1, and an int32 leaf."""
    g = np.random.default_rng(2).normal(size=(32, 64)).astype(np.float32)
    return {"w": g if rank == 0 else -g, "step_like": np.asarray(1, np.int32)}


def parity_tree(rank: int) -> dict:
    """A gradient-like tree per rank: two large leaves, a small one and an
    int32 leaf."""
    rng = np.random.default_rng(100 + rank)
    return {"conv": {"w": (1e-2 * rng.normal(size=(3, 3, 16, 24))).astype(np.float32),
                     "b": (1e-2 * rng.normal(size=(24,))).astype(np.float32)},
            "dense": (1e-3 * rng.normal(size=(40, 36))).astype(np.float32),
            "count": np.asarray(rank + 3, np.int32)}


def _codec(name):
    from repro_torch.compression import get_codec
    if name.startswith("fr"):
        return int(name[2:])
    return get_codec("fixed_accuracy", tolerance=float(name[2:]))


def main(argv) -> int:
    case, rank, world, store_file, out = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist
    from repro_torch.compression import tree_flatten_with_path
    from repro_torch.core.grad_compress import compressed_psum_tree

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world),
                            rank=rank, world_size=world)
    try:
        if case == "feedback":
            runs = {f"fr{FEEDBACK_BITS}": feedback_tree(rank)}
        else:
            runs = {name: parity_tree(rank) for name in PARITY_CODECS}
        arrays = {}
        for name, tree in runs.items():
            mean, res = compressed_psum_tree(_to_torch(tree, torch), None,
                                             _codec(name))
            for part, t in (("mean", mean), ("res", res)):
                for key, leaf in tree_flatten_with_path(t)[0]:
                    arrays[f"{name}/{part}/{key}"] = leaf.numpy()
        np.savez(out, **arrays)
    finally:
        dist.destroy_process_group()
    return 0


def _to_torch(tree, torch):
    if isinstance(tree, dict):
        return {k: _to_torch(v, torch) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
