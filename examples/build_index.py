"""Build a SPANN index on the toy 6x2 dataset and query it.

Parity with /root/reference/examples/build_index.rs: same data, config and
expected answer — query (1.0, 2.0) with k=1 returns point_id 0.
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
    config.rng_seed = 42

    data = np.array(
        [[1.0, 2.0], [1.5, 2.5], [8.0, 8.0], [8.5, 8.5], [4.0, 4.0], [4.5, 4.5]],
        dtype=np.float32,
    )

    index = SpannIndexBuilder(config).with_data(data).build(dim=2)
    result = index.find_k_nearest_neighbor_spann(np.array([1.0, 2.0]), k=1)
    print(f"[PointData(point_id={result[0].point_id}, vector={result[0].vector.tolist()})]")
    assert result[0].point_id == 0


if __name__ == "__main__":
    main()
