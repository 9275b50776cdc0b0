"""Plain PyTorch references of the benchmark's models.

No kernel, cache or batching of the port, and nothing imported from it or
from the JAX package: the models are read from the configuration files'
dicts, the weights made again from the seed (``bench/weights.py``), layer
by layer.

Each model entry of a configuration file names its reference module by
path, ``"reference": "bench/reference/<name>.py"``; an entry that names
none takes ``model.py``, the attention-and-MLP block.  The harness finds
the module with ``spec.reference(entry)`` and asks it for nothing but
these names (``c`` is the entry):

``layer_leaves(c, i)``
    (name, shape, init) of layer ``i``'s leaves, named as the port's
    ``Model.layers[i]`` names its parameters.  ``init`` says how
    ``weights.make`` draws the leaf: ``"normal:<std>"`` a bf16 normal of
    mean 0; ``"scale"`` / ``"bias"`` a float32 norm scale 1 + 0.1 N(0, 1)
    or bias 0.1 N(0, 1); ``"f32:normal:<mean>:<std>"`` or
    ``"f32:uniform:<low>:<high>"`` a float32 leaf of any other draw.
``top_leaves(c)``
    The same of the leaves outside the layers (embedding, head, final
    norm), named as ``Model`` names them.
``run(c, layer_weights, top, groups, mms)``
    The logits (float32, ``vocab_size`` columns) of each group of
    equal-length requests for each matmul rule of ``mms``, ``out[j][g]``:
    a decoder's at the last position, an encoder's at every frame.
    ``layer_weights(i)`` makes layer ``i``'s weights, ``top`` holds the
    others.
``plain_mm``, ``fp8_mm``
    The matmul rules ``run`` takes: the reference, and the control's, one
    precision below the served one.

and, where the family needs them:

``step_flops(c, b, s, *, causal=None)``, ``flash_cost(c, b, s)``
    A served batch's matmul operations, and one attention call's
    (operations, bytes), in place of ``bench/flops.py``'s frozen counts of
    the attention-and-MLP block.
``smoke(fields)``
    Shrinks the port's ``ModelConfig`` fields in place to the size the CPU
    tests run (``bench/tests/smoke.py``), in place of the dense shrink;
    ``n_layers`` is set by the tests.
"""
