"""Write a local CIFAR binary-layout dataset (``train.bin``/``test.bin``
for CIFAR-100, ``data_batch_*.bin`` for CIFAR-10) of class-separable
synthetic images.

Counterpart of the JAX package's ``examples/cifar/make_cifar_dataset.py``,
with its flags; at the same seed and sizes the files are byte for byte
the same. ``train_cifar --data-dir`` then parses them as it would the
genuine batches::

    python -m chainermn_torch.examples.make_cifar_dataset /tmp/cifar \\
        --n-train 4096
"""

import argparse

from chainermn_torch.datasets.standard_formats import save_cifar
from chainermn_torch.datasets.toy import synth_cifar_uint8


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("out")
    p.add_argument("--n-classes", type=int, default=100, choices=[10, 100])
    p.add_argument("--n-train", type=int, default=4096)
    p.add_argument("--n-test", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    xs, ys = synth_cifar_uint8(args.n_train, args.n_classes, args.seed)
    save_cifar(args.out, xs, ys, n_classes=args.n_classes, train=True)
    xs, ys = synth_cifar_uint8(args.n_test, args.n_classes, args.seed + 1)
    save_cifar(args.out, xs, ys, n_classes=args.n_classes, train=False)
    print(f"wrote CIFAR-{args.n_classes} binary batches ({args.n_train} "
          f"train / {args.n_test} test) under {args.out}")


if __name__ == "__main__":
    main()
