"""hisat2_tpu_torch.io"""
