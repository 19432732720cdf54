"""Write a local folder-of-JPEG dataset in the ImageNet layout
(``OUT/<class>/*.jpg``) for ``train_imagenet --data-dir``: generated,
learnable content (class prototypes plus noise) in real JPEG files.

Counterpart of the JAX package's ``examples/imagenet/make_jpeg_dataset.py``,
with its flags; at the same seed and sizes the files decode to the same
pixels (through :func:`~chainermn_torch.datasets.write_image_folder`)::

    python -m chainermn_torch.examples.make_jpeg_dataset OUT [--classes 8]
        [--per-class 32] [--image-size 256] [--seed 0]
"""

import argparse

from chainermn_torch.datasets.image_folder import write_image_folder


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("out")
    p.add_argument("--classes", type=int, default=8)
    p.add_argument("--per-class", type=int, default=32)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    n = write_image_folder(args.out, args.classes, args.per_class,
                           image_size=args.image_size, seed=args.seed)
    print(f"wrote {n} JPEG files under {args.out} "
          f"({args.classes} classes)")


if __name__ == "__main__":
    main()
