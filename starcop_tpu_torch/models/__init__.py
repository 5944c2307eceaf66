"""The MobileNetV2 U-Net, the inference segmenter, and weight carry-over."""
