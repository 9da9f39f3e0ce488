"""The benchmark's plain reference: Faster R-CNN ResNet-101 C4 (forward,
train targets, losses, SGD), greedy NMS, the test-time post-process and the
loader's assembly arithmetic, in float32 PyTorch and NumPy.

It follows the published algorithms (jwyang/faster-rcnn.pytorch with the
`res101_ls.yml` settings) and imports nothing of the program under test:
the benchmark hands it the same raw inputs and weights, and it recomputes
everything the program derives from them. `Precision` selects float32 or,
for the control run, fp8 (e4m3, one scale a tensor) for every convolution
and matrix product.
"""
