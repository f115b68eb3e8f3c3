"""``python -m double_yolo_kaist_torch.train``: see :mod:`.cli`."""

from .cli import main

if __name__ == "__main__":
    main()
