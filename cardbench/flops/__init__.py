"""Model FLOPs of one training step from shapes, one module per family
(``flops/<family>.py::train_flops``), the blocks in ``blocks``. The count
is of the model's arithmetic at the configuration's shapes, whatever runs
it: forward x 3 for forward and backward."""
