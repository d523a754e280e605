"""Load a previously built SPANN index and query it.

Parity with /root/reference/examples/load_index.rs (run build_index.py first).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spfresh_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import os

import numpy as np

from spfresh_tpu.index import Config, SpannIndexBuilder


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    config = Config.from_file(os.path.join(here, "example_config.yaml"))

    index = SpannIndexBuilder(config).load(dim=2)
    result = index.find_k_nearest_neighbor_spann(np.array([1.0, 2.0]), k=1)
    print(
        f"Nearest neighbour: point_id: {result[0].point_id} "
        f"and vector: {result[0].vector.tolist()}"
    )


if __name__ == "__main__":
    main()
