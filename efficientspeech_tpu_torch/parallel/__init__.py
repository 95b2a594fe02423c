from efficientspeech_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    launch,
    make_mesh,
    shard_batch,
)
