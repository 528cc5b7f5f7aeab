from iron_tpu_torch.eval.metrics import psnr_np, ssim_np, lpips_np, chamfer_distance, eval_image_folder
