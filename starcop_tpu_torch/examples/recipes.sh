#!/bin/bash
# Paper training recipes of the PyTorch port: the reference STARCOP
# repository's published invocations (bash/bash_train_example.sh),
# re-expressed for starcop_tpu_torch.cli.train, which trains on the CUDA card
# (add training.accelerator=cpu for the CPU). dataset.root_folder must hold
# the chip index CSVs.
#
#     bash starcop_tpu_torch/examples/recipes.sh /path/to/chips

ROOT=${1:-/data/starcop_chips}

# 1. HyperSTARCOP mag1c + RGB (pos_weight 1)
python -m starcop_tpu_torch.cli.train \
  experiment_name=hyperstarcop_magic_rgb \
  dataset.root_folder="$ROOT" \
  'dataset.input_products=["mag1c","TOA_AVIRIS_640nm","TOA_AVIRIS_550nm","TOA_AVIRIS_460nm"]' \
  model.pos_weight=1

# 2. HyperSTARCOP mag1c only
python -m starcop_tpu_torch.cli.train \
  experiment_name=hyperstarcop_magic_only \
  dataset.root_folder="$ROOT" \
  'dataset.input_products=["mag1c"]' \
  model.pos_weight=1

# 3. MultiSTARCOP Varon ratios (pos_weight 15)
python -m starcop_tpu_torch.cli.train \
  experiment_name=multistarcop_varon \
  dataset.root_folder="$ROOT" \
  'dataset.input_products=["ratio_wv3_B7_B5_varon21_sum_c_out","ratio_wv3_B8_B5_varon21_sum_c_out","ratio_wv3_B7_B6_varon21_sum_c_out"]' \
  model.pos_weight=15

# 4. MultiSTARCOP Sanchez ratios
python -m starcop_tpu_torch.cli.train \
  experiment_name=multistarcop_sanchez \
  dataset.root_folder="$ROOT" \
  'dataset.input_products=["ratio_wv3_B7_B7MLR_SanchezGarcia22_sum_c_out","ratio_wv3_B8_B8MLR_SanchezGarcia22_sum_c_out"]' \
  model.pos_weight=15

# 5. MultiSTARCOP Varon + Sanchez
python -m starcop_tpu_torch.cli.train \
  experiment_name=multistarcop_varon_sanchez \
  dataset.root_folder="$ROOT" \
  'dataset.input_products=["ratio_wv3_B7_B5_varon21_sum_c_out","ratio_wv3_B8_B5_varon21_sum_c_out","ratio_wv3_B7_B6_varon21_sum_c_out","ratio_wv3_B7_B7MLR_SanchezGarcia22_sum_c_out","ratio_wv3_B8_B8MLR_SanchezGarcia22_sum_c_out"]' \
  model.pos_weight=15
