"""Plain reference of the hand pipeline (HandTrackNet, IKNet, MANO, the shape
and pose optimisers): frozen copies of the port's plain code, which the
port's tests hold against the JAX package, without its kernel dispatch;
`hand_pose` composes the pose optimiser's energy of plain parts."""
