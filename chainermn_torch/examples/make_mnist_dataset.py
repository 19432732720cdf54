"""Write a local MNIST-layout dataset: the standard IDX files
(``train-images-idx3-ubyte`` etc.) of class-separable synthetic digits.

Counterpart of the JAX package's ``examples/mnist/make_mnist_dataset.py``,
with its flags; at the same seed and sizes the files are byte for byte
the same. ``train_mnist --data-dir`` then parses them as it would the
genuine LeCun files::

    python -m chainermn_torch.examples.make_mnist_dataset /tmp/mnist \\
        --n-train 4096
"""

import argparse

from chainermn_torch.datasets.standard_formats import save_mnist
from chainermn_torch.datasets.toy import synth_uint8


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("out")
    p.add_argument("--n-train", type=int, default=4096)
    p.add_argument("--n-test", type=int, default=1024)
    p.add_argument("--gz", action="store_true",
                   help="write the gzipped spellings (*.gz) like the "
                        "distributed files")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    xs, ys = synth_uint8(args.n_train, args.seed)
    save_mnist(args.out, xs, ys, train=True, gz=args.gz)
    xs, ys = synth_uint8(args.n_test, args.seed + 1)
    save_mnist(args.out, xs, ys, train=False, gz=args.gz)
    print(f"wrote MNIST IDX files ({args.n_train} train / "
          f"{args.n_test} test) under {args.out}")


if __name__ == "__main__":
    main()
