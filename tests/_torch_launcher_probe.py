"""A child of the launcher tests (``test_torch_launcher.py``); imports
nothing of either package.

``env``: print one JSON line of the launcher's variables this child got.
``fail``: the process whose rank is 1 exits 1 at once, the others sleep
until the launcher reaps them."""

import json
import os
import sys
import time

PREFIXES = ("HOROVOD_TPU_", "MASTER_", "TORCHELASTIC_")


def main() -> None:
    env = {k: v for k, v in os.environ.items() if k.startswith(PREFIXES)}
    if sys.argv[1] == "env":
        # One write: the children share the launcher's stdout, where two
        # buffered prints could land on one line.
        os.write(1, ("ENV " + json.dumps(env, sort_keys=True) + "\n")
                 .encode())
    elif env.get("HOROVOD_TPU_RANK") == "1":
        sys.exit(1)
    else:
        time.sleep(120)


if __name__ == "__main__":
    main()
