"""Launch helpers of the port: device meshes, the serving and the training
entry points."""
