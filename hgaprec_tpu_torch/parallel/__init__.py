from hgaprec_tpu_torch.parallel.sharded import (ShardedRun, build_sharded_run,
                                                sharded_masked_topk)

__all__ = ["ShardedRun", "build_sharded_run", "sharded_masked_topk"]
