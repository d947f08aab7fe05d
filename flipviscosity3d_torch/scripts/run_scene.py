"""Scene driver: the counterpart of the JAX package's scripts/run_scene.py,
calling the port's command line (flipviscosity3d_torch/cli.py) with the
same arguments.

    python -m flipviscosity3d_torch.scripts.run_scene --scene drop.json \
        --frames 4 [--device cpu]
"""

from ..cli import main

if __name__ == "__main__":
    main()
