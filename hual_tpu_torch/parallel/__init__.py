from hual_tpu_torch.parallel.mesh import (Mesh, RowDraws, Rows, RowShard,
                                          gather_outputs, gather_rows,
                                          make_mesh, pad_rows, row_draws,
                                          sum_grads, sum_over, uniform, whole)

__all__ = ["Mesh", "RowDraws", "RowShard", "Rows", "gather_outputs",
           "gather_rows", "make_mesh", "pad_rows", "row_draws", "sum_grads",
           "sum_over", "uniform", "whole"]
