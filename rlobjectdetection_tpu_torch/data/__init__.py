"""The port's data and eval layer: images to blobs, datasets and roidbs,
the batch loader and its prefetch to the card, VOC and COCO evaluation, and
synthetic fixtures (its own copies; the JAX package's data modules are not
imported)."""
