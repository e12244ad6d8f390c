from .pointops import (
    farthest_point_sample,
    gather_operation,
    group_operation,
    index_points,
    knn_point,
    query_ball_point,
    sample_and_group_all,
    square_distance,
    three_interpolate,
    three_nn,
)

__all__ = ["farthest_point_sample", "gather_operation", "group_operation",
           "index_points", "knn_point", "query_ball_point",
           "sample_and_group_all", "square_distance", "three_interpolate",
           "three_nn"]
