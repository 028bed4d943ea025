"""Model zoo of the port (≙ ``bigdl_tpu/models``): ``lenet``, ``resnet``,
``vgg``, ``transformer`` and ``two_tower``, each imported by name."""
