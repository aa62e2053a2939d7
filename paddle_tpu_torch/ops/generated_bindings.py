"""Generated from ops/ops.yaml by tools/gen_op_bindings_torch.py; do not
edit. Regenerate with: python tools/gen_op_bindings_torch.py

One def per manifest entry, carrying the manifest's signature: unknown
keywords and wrong arity fail here with a TypeError naming the op,
before the op runs. `paddle_tpu_torch._C_ops`, the Tensor methods and
the top-level op names are built from this module. A registered op
resolves from the registry at call time; an op that another item of
the port brings raises `WaitingOp` naming the item.
"""
from math import inf, nan  # noqa: F401  (signature defaults)

from .dispatch import OPS as _OPS
from .kernels._util import waiting_error as _waiting_error


def abs(x):
    return _OPS['abs'](x)


def accuracy(x, indices, label, k=1):
    return _OPS['accuracy'](x, indices, label, k=k)


def accuracy_check(x, y, fn_name='', rtol=1e-05, atol=1e-08, equal_nan=False):
    return _OPS['accuracy_check'](x, y, fn_name=fn_name, rtol=rtol, atol=atol, equal_nan=equal_nan)


def acos(x):
    return _OPS['acos'](x)


def acosh(x):
    return _OPS['acosh'](x)


def adadelta_(param, grad, avg_squared_grad, avg_squared_update, learning_rate=1.0, rho=0.95, epsilon=1e-06):
    return _OPS['adadelta_'](param, grad, avg_squared_grad, avg_squared_update, learning_rate=learning_rate, rho=rho, epsilon=epsilon)


def adagrad_(param, grad, moment, learning_rate, epsilon=1e-06):
    return _OPS['adagrad_'](param, grad, moment, learning_rate, epsilon=epsilon)


def adam_(param, grad, learning_rate, moment1, moment2, beta1_pow, beta2_pow, beta1=0.9, beta2=0.999, epsilon=1e-08):
    return _OPS['adam_'](param, grad, learning_rate, moment1, moment2, beta1_pow, beta2_pow, beta1=beta1, beta2=beta2, epsilon=epsilon)


def adamax_(param, grad, learning_rate, moment, inf_norm, beta1_pow, beta1=0.9, beta2=0.999, epsilon=1e-08):
    return _OPS['adamax_'](param, grad, learning_rate, moment, inf_norm, beta1_pow, beta1=beta1, beta2=beta2, epsilon=epsilon)


def adamw_(param, grad, learning_rate, moment1, moment2, beta1_pow, beta2_pow, beta1=0.9, beta2=0.999, epsilon=1e-08, weight_decay=0.01, lr_ratio=1.0):
    return _OPS['adamw_'](param, grad, learning_rate, moment1, moment2, beta1_pow, beta2_pow, beta1=beta1, beta2=beta2, epsilon=epsilon, weight_decay=weight_decay, lr_ratio=lr_ratio)


def adaptive_avg_pool1d(x, output_size):
    return _OPS['adaptive_avg_pool1d'](x, output_size)


def adaptive_avg_pool2d(x, output_size, data_format='NCHW'):
    return _OPS['adaptive_avg_pool2d'](x, output_size, data_format=data_format)


def adaptive_avg_pool3d(x, output_size, data_format='NCDHW'):
    return _OPS['adaptive_avg_pool3d'](x, output_size, data_format=data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False):
    return _OPS['adaptive_max_pool1d'](x, output_size, return_mask=return_mask)


def adaptive_max_pool2d(x, output_size, data_format='NCHW'):
    return _OPS['adaptive_max_pool2d'](x, output_size, data_format=data_format)


def adaptive_max_pool3d(x, output_size, return_mask=False, data_format='NCDHW'):
    return _OPS['adaptive_max_pool3d'](x, output_size, return_mask=return_mask, data_format=data_format)


def add(x, y):
    return _OPS['add'](x, y)


def add_group_norm_silu(x, residual=None, scale=None, bias=None, epsilon=1e-05, groups=1, data_format='NCHW', activation='silu'):
    return _OPS['add_group_norm_silu'](x, residual=residual, scale=scale, bias=bias, epsilon=epsilon, groups=groups, data_format=data_format, activation=activation)


def add_n(inputs):
    return _OPS['add_n'](inputs)


def add_position_encoding(x, alpha=1.0, beta=1.0):
    return _OPS['add_position_encoding'](x, alpha=alpha, beta=beta)


def addmm(input, x, y, beta=1.0, alpha=1.0):
    return _OPS['addmm'](input, x, y, beta=beta, alpha=alpha)


def affine_channel(x, scale, bias, data_format='NCHW'):
    return _OPS['affine_channel'](x, scale, bias, data_format=data_format)


def affine_grid(theta, out_shape, align_corners=True):
    return _OPS['affine_grid'](theta, out_shape, align_corners=align_corners)


def all(x, axis=None, keepdim=False):
    return _OPS['all'](x, axis=axis, keepdim=keepdim)


def all_gather(x, ring_id=0, nranks=1):
    raise _waiting_error('all_gather')  # item 7


def all_reduce(x, reduce_type=0, ring_id=0):
    raise _waiting_error('all_reduce')  # item 7


def all_to_all(x, ring_id=0):
    raise _waiting_error('all_to_all')  # item 7


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return _OPS['allclose'](x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def amax(x, axis=None, keepdim=False):
    return _OPS['amax'](x, axis=axis, keepdim=keepdim)


def amin(x, axis=None, keepdim=False):
    return _OPS['amin'](x, axis=axis, keepdim=keepdim)


def anchor_generator(input, anchor_sizes=(), aspect_ratios=(), variances=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0), offset=0.5):
    return _OPS['anchor_generator'](input, anchor_sizes=anchor_sizes, aspect_ratios=aspect_ratios, variances=variances, stride=stride, offset=offset)


def angle(x):
    return _OPS['angle'](x)


def any(x, axis=None, keepdim=False):
    return _OPS['any'](x, axis=axis, keepdim=keepdim)


def apply_per_channel_scale(x, scales):
    return _OPS['apply_per_channel_scale'](x, scales)


def arange(start=0, end=None, step=1, dtype=None):
    return _OPS['arange'](start=start, end=end, step=step, dtype=dtype)


def argmax(x, axis=None, keepdim=False, dtype='int64'):
    return _OPS['argmax'](x, axis=axis, keepdim=keepdim, dtype=dtype)


def argmin(x, axis=None, keepdim=False, dtype='int64'):
    return _OPS['argmin'](x, axis=axis, keepdim=keepdim, dtype=dtype)


def argsort(x, axis=-1, descending=False, stable=False):
    return _OPS['argsort'](x, axis=axis, descending=descending, stable=stable)


def as_complex(x):
    return _OPS['as_complex'](x)


def as_real(x):
    return _OPS['as_real'](x)


def as_strided(input, dims=(), stride=(), offset=0):
    return _OPS['as_strided'](input, dims=dims, stride=stride, offset=offset)


def asgd_(param, grad, learning_rate, d, y, n):
    return _OPS['asgd_'](param, grad, learning_rate, d, y, n)


def asin(x):
    return _OPS['asin'](x)


def asinh(x):
    return _OPS['asinh'](x)


def assign(x):
    return _OPS['assign'](x)


def assign_out_(x, output):
    raise _waiting_error('assign_out_')  # item 7


def assign_pos(x, cum_count, eff_num_len=None):
    return _OPS['assign_pos'](x, cum_count, eff_num_len=eff_num_len)


def assign_value(shape=(), dtype='float32', values=()):
    return _OPS['assign_value'](shape=shape, dtype=dtype, values=values)


def assign_value_(output, shape=None, dtype=None, values=()):
    raise _waiting_error('assign_value_')  # item 7


def atan(x):
    return _OPS['atan'](x)


def atan2(x, y):
    return _OPS['atan2'](x, y)


def atanh(x):
    return _OPS['atanh'](x)


def attention_lstm(x, c0, h0, attention_weight, attention_bias, attention_scalar, attention_scalar_bias, lstm_weight, lstm_bias, lod, gate_activation='sigmoid', cell_activation='tanh', candidate_activation='tanh'):
    return _OPS['attention_lstm'](x, c0, h0, attention_weight, attention_bias, attention_scalar, attention_scalar_bias, lstm_weight, lstm_bias, lod, gate_activation=gate_activation, cell_activation=cell_activation, candidate_activation=candidate_activation)


def auc(predict, label, stat_pos=None, stat_neg=None, num_thresholds=4095, curve='ROC', slide_steps=1, ins_tag_weight=None):
    return _OPS['auc'](predict, label, stat_pos=stat_pos, stat_neg=stat_neg, num_thresholds=num_thresholds, curve=curve, slide_steps=slide_steps, ins_tag_weight=ins_tag_weight)


def average_accumulates_(param, in_sum_1, in_sum_2, in_sum_3, in_num_accumulates, in_old_num_accumulates, in_num_updates, average_window=0.0, max_average_window=16384, min_average_window=10000):
    return _OPS['average_accumulates_'](param, in_sum_1, in_sum_2, in_sum_3, in_num_accumulates, in_old_num_accumulates, in_num_updates, average_window=average_window, max_average_window=max_average_window, min_average_window=min_average_window)


def avg_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True, data_format='NCL'):
    return _OPS['avg_pool1d'](x, kernel_size, stride=stride, padding=padding, ceil_mode=ceil_mode, exclusive=exclusive, data_format=data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True, data_format='NCHW'):
    return _OPS['avg_pool2d'](x, kernel_size, stride=stride, padding=padding, ceil_mode=ceil_mode, exclusive=exclusive, data_format=data_format)


def barrier(x=None, ring_id=0):
    raise _waiting_error('barrier')  # item 7


def batch_fc(input, w, bias=None):
    return _OPS['batch_fc'](input, w, bias=bias)


def batch_norm(x, mean, variance, scale=None, bias=None, is_test=False, momentum=0.9, epsilon=1e-05, data_format='NCHW', use_global_stats=False, trainable_statistics=False):
    return _OPS['batch_norm'](x, mean, variance, scale=scale, bias=bias, is_test=is_test, momentum=momentum, epsilon=epsilon, data_format=data_format, use_global_stats=use_global_stats, trainable_statistics=trainable_statistics)


def batch_norm_(x, mean, variance, scale=None, bias=None, is_test=False, momentum=0.9, epsilon=1e-05, data_format='NCHW', use_global_stats=False, trainable_statistics=False):
    return _OPS['batch_norm_'](x, mean, variance, scale=scale, bias=bias, is_test=is_test, momentum=momentum, epsilon=epsilon, data_format=data_format, use_global_stats=use_global_stats, trainable_statistics=trainable_statistics)


def batch_norm_infer(x, mean, variance, weight=None, bias=None, epsilon=1e-05, data_format='NCHW'):
    return _OPS['batch_norm_infer'](x, mean, variance, weight=weight, bias=bias, epsilon=epsilon, data_format=data_format)


def batch_norm_train(x, weight=None, bias=None, epsilon=1e-05, data_format='NCHW'):
    return _OPS['batch_norm_train'](x, weight=weight, bias=bias, epsilon=epsilon, data_format=data_format)


def bce_loss(input, label):
    return _OPS['bce_loss'](input, label)


def bce_with_logits(logit, label, weight=None, pos_weight=None):
    return _OPS['bce_with_logits'](logit, label, weight=weight, pos_weight=pos_weight)


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id, level=0, is_accumulated=True, return_parent_idx=True):
    return _OPS['beam_search'](pre_ids, pre_scores, ids, scores, beam_size, end_id, level=level, is_accumulated=is_accumulated, return_parent_idx=return_parent_idx)


def beam_search_decode(step_ids, step_parents, step_scores=None, beam_size=1, end_id=0):
    return _OPS['beam_search_decode'](step_ids, step_parents, step_scores=step_scores, beam_size=beam_size, end_id=end_id)


def bernoulli(x, p=None, seed=0):
    return _OPS['bernoulli'](x, p=p, seed=seed)


def bicubic_interp(x, out_h, out_w, align_corners=True):
    return _OPS['bicubic_interp'](x, out_h, out_w, align_corners=align_corners)


def bilinear(x, y, weight, bias=None):
    return _OPS['bilinear'](x, y, weight, bias=bias)


def bilinear_interp(x, out_h, out_w, align_corners=True, align_mode=1):
    return _OPS['bilinear_interp'](x, out_h, out_w, align_corners=align_corners, align_mode=align_mode)


def bincount(x, weights=None, minlength=0):
    return _OPS['bincount'](x, weights=weights, minlength=minlength)


def binomial(count, prob, seed=0):
    return _OPS['binomial'](count, prob, seed=seed)


def bipartite_match(dist_mat, match_type='bipartite', dist_threshold=0.5):
    return _OPS['bipartite_match'](dist_mat, match_type=match_type, dist_threshold=dist_threshold)


def bitwise_and(x, y):
    return _OPS['bitwise_and'](x, y)


def bitwise_left_shift(x, y, is_arithmetic=True):
    return _OPS['bitwise_left_shift'](x, y, is_arithmetic=is_arithmetic)


def bitwise_not(x):
    return _OPS['bitwise_not'](x)


def bitwise_or(x, y):
    return _OPS['bitwise_or'](x, y)


def bitwise_right_shift(x, y, is_arithmetic=True):
    return _OPS['bitwise_right_shift'](x, y, is_arithmetic=is_arithmetic)


def bitwise_xor(x, y):
    return _OPS['bitwise_xor'](x, y)


def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size):
    return _OPS['blha_get_max_len'](seq_lens_encoder, seq_lens_decoder, batch_size)


def block_multihead_attention_(qkv, key_cache, value_cache, seq_lens_encoder, seq_lens_decoder, seq_lens_this_time, padding_offsets=None, cum_offsets=None, cu_seqlens_q=None, cu_seqlens_k=None, block_tables=None, pre_key_cache=None, pre_value_cache=None, rope_emb=None, mask=None, tgt_mask=None, cache_k_quant_scales=None, cache_v_quant_scales=None, cache_k_dequant_scales=None, cache_v_dequant_scales=None, qkv_out_scale=None, qkv_bias=None, out_shift=None, out_smooth=None, max_enc_len_this_time=None, max_dec_len_this_time=None, max_seq_len=-1, block_size=64, use_neox_style=False, dynamic_cachekv_quant=False, quant_round_type=1, quant_max_bound=127.0, quant_min_bound=-127.0, out_scale=-1.0, compute_dtype='default', rope_theta=10000.0, use_pallas=None):
    return _OPS['block_multihead_attention_'](qkv, key_cache, value_cache, seq_lens_encoder, seq_lens_decoder, seq_lens_this_time, padding_offsets=padding_offsets, cum_offsets=cum_offsets, cu_seqlens_q=cu_seqlens_q, cu_seqlens_k=cu_seqlens_k, block_tables=block_tables, pre_key_cache=pre_key_cache, pre_value_cache=pre_value_cache, rope_emb=rope_emb, mask=mask, tgt_mask=tgt_mask, cache_k_quant_scales=cache_k_quant_scales, cache_v_quant_scales=cache_v_quant_scales, cache_k_dequant_scales=cache_k_dequant_scales, cache_v_dequant_scales=cache_v_dequant_scales, qkv_out_scale=qkv_out_scale, qkv_bias=qkv_bias, out_shift=out_shift, out_smooth=out_smooth, max_enc_len_this_time=max_enc_len_this_time, max_dec_len_this_time=max_dec_len_this_time, max_seq_len=max_seq_len, block_size=block_size, use_neox_style=use_neox_style, dynamic_cachekv_quant=dynamic_cachekv_quant, quant_round_type=quant_round_type, quant_max_bound=quant_max_bound, quant_min_bound=quant_min_bound, out_scale=out_scale, compute_dtype=compute_dtype, rope_theta=rope_theta, use_pallas=use_pallas)


def bmm(x, y):
    return _OPS['bmm'](x, y)


def box_clip(input, im_info):
    return _OPS['box_clip'](input, im_info)


def box_coder(prior_box, prior_box_var, target_box, code_type='encode_center_size', box_normalized=True, axis=0):
    return _OPS['box_coder'](prior_box, prior_box_var, target_box, code_type=code_type, box_normalized=box_normalized, axis=axis)


def broadcast(x, root=0, ring_id=0):
    raise _waiting_error('broadcast')  # item 7


def broadcast_tensors(inputs):
    return _OPS['broadcast_tensors'](inputs)


def broadcast_to(x, shape):
    return _OPS['broadcast_to'](x, shape)


def c_allgather(x, ring_id=0, nranks=1, use_calc_stream=True):
    raise _waiting_error('c_allgather')  # item 7


def c_allreduce_max(x, ring_id=0, use_calc_stream=True, use_model_parallel=False):
    raise _waiting_error('c_allreduce_max')  # item 7


def c_allreduce_min(x, ring_id=0, use_calc_stream=True, use_model_parallel=False):
    raise _waiting_error('c_allreduce_min')  # item 7


def c_allreduce_prod(x, ring_id=0, use_calc_stream=True, use_model_parallel=False):
    raise _waiting_error('c_allreduce_prod')  # item 7


def c_allreduce_sum(x, ring_id=0, use_calc_stream=True, use_model_parallel=False):
    raise _waiting_error('c_allreduce_sum')  # item 7


def c_broadcast(x, root=0, ring_id=0, use_calc_stream=True):
    raise _waiting_error('c_broadcast')  # item 7


def c_concat(x, rank=0, nranks=1, ring_id=0, use_calc_stream=True, use_model_parallel=True):
    raise _waiting_error('c_concat')  # item 7


def c_embedding(weight, x, start_index=0, vocab_size=-1):
    return _OPS['c_embedding'](weight, x, start_index=start_index, vocab_size=vocab_size)


def c_identity(x, ring_id=0, use_calc_stream=True, use_model_parallel=True):
    raise _waiting_error('c_identity')  # item 7


def c_reduce_sum(x, root_id=0, ring_id=0, use_calc_stream=True):
    raise _waiting_error('c_reduce_sum')  # item 7


def c_scatter(x, root=0, ring_id=0, nranks=1, use_calc_stream=True):
    raise _waiting_error('c_scatter')  # item 7


def c_softmax_with_cross_entropy(logits, label, ignore_index=-100, ring_id=0, rank=0, nranks=1):
    raise _waiting_error('c_softmax_with_cross_entropy')  # item 7


def c_split(x, rank=0, nranks=1, ring_id=0, use_calc_stream=False, use_model_parallel=True):
    return _OPS['c_split'](x, rank=rank, nranks=nranks, ring_id=ring_id, use_calc_stream=use_calc_stream, use_model_parallel=use_model_parallel)


def calc_reduced_attn_scores(q, k, softmax_lse):
    return _OPS['calc_reduced_attn_scores'](q, k, softmax_lse)


def cast(x, dtype):
    return _OPS['cast'](x, dtype)


def ceil(x):
    return _OPS['ceil'](x)


def celu(x, alpha=1.0):
    return _OPS['celu'](x, alpha=alpha)


def channel_shuffle(x, groups=1, data_format='NCHW'):
    return _OPS['channel_shuffle'](x, groups=groups, data_format=data_format)


def check_finite_and_unscale_(xs, scale):
    return _OPS['check_finite_and_unscale_'](xs, scale)


def check_numerics(x, op_type='', var_name='', check_nan_inf_level=0, stack_height_limit=-1, output_dir=''):
    return _OPS['check_numerics'](x, op_type=op_type, var_name=var_name, check_nan_inf_level=check_nan_inf_level, stack_height_limit=stack_height_limit, output_dir=output_dir)


def cholesky(x, upper=False):
    return _OPS['cholesky'](x, upper=upper)


def cholesky_solve(x, y, upper=False):
    return _OPS['cholesky_solve'](x, y, upper=upper)


def chunk(x, chunks, axis=0):
    return _OPS['chunk'](x, chunks, axis=axis)


def chunk_eval(inference, label, num_chunk_types, chunk_scheme='IOB', excluded_chunk_types=None, seq_length=None):
    return _OPS['chunk_eval'](inference, label, num_chunk_types, chunk_scheme=chunk_scheme, excluded_chunk_types=excluded_chunk_types, seq_length=seq_length)


def class_center_sample(label, num_classes, num_samples, ring_id=0, rank=0, nranks=1, fix_seed=False, seed=0):
    return _OPS['class_center_sample'](label, num_classes, num_samples, ring_id=ring_id, rank=rank, nranks=nranks, fix_seed=fix_seed, seed=seed)


def clip(x, min=None, max=None):
    return _OPS['clip'](x, min=min, max=max)


def clip_by_norm(x, max_norm):
    return _OPS['clip_by_norm'](x, max_norm)


def coalesce(x):
    raise _waiting_error('coalesce')  # item 9


def coalesce_tensor(input, dtype=None, copy_data=True, set_constant=False, constant=0.0, persist_output=False, align_size=-1):
    raise _waiting_error('coalesce_tensor')  # item 7


def collect_fpn_proposals(multi_rois, multi_scores, rois_num_per_level, post_nms_topn=100):
    return _OPS['collect_fpn_proposals'](multi_rois, multi_scores, rois_num_per_level, post_nms_topn=post_nms_topn)


def comm_init_all(devices=(), ring_id=0):
    raise _waiting_error('comm_init_all')  # item 7


def complex(real, imag):
    return _OPS['complex'](real, imag)


def concat(xs, axis=0):
    return _OPS['concat'](xs, axis=axis)


def cond(x, p=None):
    return _OPS['cond'](x, p=p)


def conj(x):
    return _OPS['conj'](x)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1, data_format='NCL'):
    return _OPS['conv1d'](x, weight, bias=bias, stride=stride, padding=padding, dilation=dilation, groups=groups, data_format=data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1, data_format='NCHW'):
    return _OPS['conv2d'](x, weight, bias=bias, stride=stride, padding=padding, dilation=dilation, groups=groups, data_format=data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, dilation=1, groups=1, data_format='NCHW'):
    return _OPS['conv2d_transpose'](x, weight, bias=bias, stride=stride, padding=padding, output_padding=output_padding, dilation=dilation, groups=groups, data_format=data_format)


def conv2d_transpose_bias(x, filter, bias, strides=(1, 1), paddings=(0, 0), output_padding=(), output_size=(), padding_algorithm='EXPLICIT', groups=1, dilations=(1, 1), data_format='NCHW'):
    return _OPS['conv2d_transpose_bias'](x, filter, bias, strides=strides, paddings=paddings, output_padding=output_padding, output_size=output_size, padding_algorithm=padding_algorithm, groups=groups, dilations=dilations, data_format=data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1, data_format='NCDHW'):
    return _OPS['conv3d'](x, weight, bias=bias, stride=stride, padding=padding, dilation=dilation, groups=groups, data_format=data_format)


def conv3d_implicit_gemm(x, filter, strides=(1, 1, 1), paddings=(0, 0, 0), padding_algorithm='EXPLICIT', groups=1, dilations=(1, 1, 1), data_format='NCDHW'):
    return _OPS['conv3d_implicit_gemm'](x, filter, strides=strides, paddings=paddings, padding_algorithm=padding_algorithm, groups=groups, dilations=dilations, data_format=data_format)


def conv3d_transpose(x, filter, bias=None, strides=1, paddings=0, output_padding=0, output_size=None, padding_algorithm='EXPLICIT', groups=1, dilations=1, data_format='NCDHW'):
    return _OPS['conv3d_transpose'](x, filter, bias=bias, strides=strides, paddings=paddings, output_padding=output_padding, output_size=output_size, padding_algorithm=padding_algorithm, groups=groups, dilations=dilations, data_format=data_format)


def copy_to(x, place=None, blocking=True):
    raise _waiting_error('copy_to')  # item 7


def copysign(x, y):
    return _OPS['copysign'](x, y)


def corrcoef(x, rowvar=True):
    return _OPS['corrcoef'](x, rowvar=rowvar)


def correlation(input1, input2, pad_size, kernel_size, max_displacement, stride1, stride2, corr_type_multiply=1):
    return _OPS['correlation'](input1, input2, pad_size, kernel_size, max_displacement, stride1, stride2, corr_type_multiply=corr_type_multiply)


def cos(x):
    return _OPS['cos'](x)


def cosh(x):
    return _OPS['cosh'](x)


def count_nonzero(x, axis=None, keepdim=False):
    return _OPS['count_nonzero'](x, axis=axis, keepdim=keepdim)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    return _OPS['cov'](x, rowvar=rowvar, ddof=ddof, fweights=fweights, aweights=aweights)


def crf_decoding(emission, transition, label=None, length=None):
    return _OPS['crf_decoding'](emission, transition, label=label, length=length)


def crop(x, shape, offsets=None):
    return _OPS['crop'](x, shape, offsets=offsets)


def cross(x, y, axis=None):
    return _OPS['cross'](x, y, axis=axis)


def cross_entropy(x, label, soft_label=False, ignore_index=-100):
    return _OPS['cross_entropy'](x, label, soft_label=soft_label, ignore_index=ignore_index)


def cross_entropy2(x, label, ignore_index=-100):
    return _OPS['cross_entropy2'](x, label, ignore_index=ignore_index)


def cross_entropy_with_softmax(logits, label, soft_label=False, use_softmax=True, numeric_stable_mode=True, ignore_index=-100, axis=-1):
    return _OPS['cross_entropy_with_softmax'](logits, label, soft_label=soft_label, use_softmax=use_softmax, numeric_stable_mode=numeric_stable_mode, ignore_index=ignore_index, axis=axis)


def ctc_align(input, input_length=None, blank=0, merge_repeated=True, padding_value=0):
    return _OPS['ctc_align'](input, input_length=input_length, blank=blank, merge_repeated=merge_repeated, padding_value=padding_value)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0, norm_by_times=False):
    return _OPS['ctc_loss'](log_probs, labels, input_lengths, label_lengths, blank=blank, norm_by_times=norm_by_times)


def cudnn_lstm(x, init_h, init_c, w=None, weight_list=None, sequence_length=None, dropout_prob=0.0, is_bidirec=False, hidden_size=100, num_layers=1, is_test=False, seed=0):
    return _OPS['cudnn_lstm'](x, init_h, init_c, w=w, weight_list=weight_list, sequence_length=sequence_length, dropout_prob=dropout_prob, is_bidirec=is_bidirec, hidden_size=hidden_size, num_layers=num_layers, is_test=is_test, seed=seed)


def cummax(x, axis=None):
    return _OPS['cummax'](x, axis=axis)


def cummin(x, axis=None):
    return _OPS['cummin'](x, axis=axis)


def cumprod(x, dim=None):
    return _OPS['cumprod'](x, dim=dim)


def cumsum(x, axis=None):
    return _OPS['cumsum'](x, axis=axis)


def cvm(x, cvm_input, use_cvm=True):
    return _OPS['cvm'](x, cvm_input, use_cvm=use_cvm)


def data(name='', shape=(), dtype='float32', place=None):
    return _OPS['data'](name=name, shape=shape, dtype=dtype, place=place)


def decayed_adagrad(param, grad, moment, learning_rate, decay=0.95, epsilon=1e-06):
    return _OPS['decayed_adagrad'](param, grad, moment, learning_rate, decay=decay, epsilon=epsilon)


def decode_jpeg(x, mode='unchanged'):
    return _OPS['decode_jpeg'](x, mode=mode)


def deformable_conv(x, offset, weight, mask=None, stride=1, padding=0, dilation=1, deformable_groups=1, groups=1, im2col_step=1):
    return _OPS['deformable_conv'](x, offset, weight, mask=mask, stride=stride, padding=padding, dilation=dilation, deformable_groups=deformable_groups, groups=groups, im2col_step=im2col_step)


def deg2rad(x):
    return _OPS['deg2rad'](x)


def depend(x, dep=None):
    raise _waiting_error('depend')  # item 7


def depthwise_conv2d(x, weight, stride=1, padding=0, dilation=1, data_format='NCHW'):
    return _OPS['depthwise_conv2d'](x, weight, stride=stride, padding=padding, dilation=dilation, data_format=data_format)


def depthwise_conv2d_transpose(x, filter, bias=None, strides=1, paddings=0, output_padding=0, output_size=None, padding_algorithm='EXPLICIT', groups=None, dilations=1, data_format='NCHW'):
    return _OPS['depthwise_conv2d_transpose'](x, filter, bias=bias, strides=strides, paddings=paddings, output_padding=output_padding, output_size=output_size, padding_algorithm=padding_algorithm, groups=groups, dilations=dilations, data_format=data_format)


def dequantize_abs_max(x, scale, max_range):
    return _OPS['dequantize_abs_max'](x, scale, max_range)


def dequantize_linear(x, scale, zero_point=None, in_accum=None, in_state=None, quant_axis=0, bit_length=8, qmin=-128, qmax=127, round_type=0, is_test=True, only_observer=False):
    return _OPS['dequantize_linear'](x, scale, zero_point=zero_point, in_accum=in_accum, in_state=in_state, quant_axis=quant_axis, bit_length=bit_length, qmin=qmin, qmax=qmax, round_type=round_type, is_test=is_test, only_observer=only_observer)


def dequantize_log(x, dict):
    return _OPS['dequantize_log'](x, dict)


def det(x):
    return _OPS['det'](x)


def detection_map(detect_res, label, num_classes, background_label=0, overlap_threshold=0.5, evaluate_difficult=True, ap_type='integral'):
    return _OPS['detection_map'](detect_res, label, num_classes, background_label=background_label, overlap_threshold=overlap_threshold, evaluate_difficult=evaluate_difficult, ap_type=ap_type)


def dgc(u, v, grad, param, current_step, nranks, m=0.9, use_nesterov=True, sparsity=(), rampup_begin_step=0.0, rampup_step=0.0, regular_coeff=0.0, regular_type=0):
    return _OPS['dgc'](u, v, grad, param, current_step, nranks, m=m, use_nesterov=use_nesterov, sparsity=sparsity, rampup_begin_step=rampup_begin_step, rampup_step=rampup_step, regular_coeff=regular_coeff, regular_type=regular_type)


def dgc_clip_by_norm(x, current_step, max_norm=1.0, rampup_begin_step=-1.0):
    return _OPS['dgc_clip_by_norm'](x, current_step, max_norm=max_norm, rampup_begin_step=rampup_begin_step)


def dgc_momentum(param, grad, velocity, learning_rate, master_param, current_step_tensor, nranks_tensor, mu=0.9, use_nesterov=False, regularization_method='', regularization_coeff=0.0, multi_precision=False, rescale_grad=1.0, rampup_begin_step=-1.0):
    return _OPS['dgc_momentum'](param, grad, velocity, learning_rate, master_param, current_step_tensor, nranks_tensor, mu=mu, use_nesterov=use_nesterov, regularization_method=regularization_method, regularization_coeff=regularization_coeff, multi_precision=multi_precision, rescale_grad=rescale_grad, rampup_begin_step=rampup_begin_step)


def diag(x, offset=0, padding_value=0):
    return _OPS['diag'](x, offset=offset, padding_value=padding_value)


def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return _OPS['diag_embed'](x, offset=offset, dim1=dim1, dim2=dim2)


def diagflat(x, offset=0):
    return _OPS['diagflat'](x, offset=offset)


def diagonal(x, offset=0, axis1=0, axis2=1):
    return _OPS['diagonal'](x, offset=offset, axis1=axis1, axis2=axis2)


def digamma(x):
    return _OPS['digamma'](x)


def dirichlet(alpha, seed=0):
    return _OPS['dirichlet'](alpha, seed=seed)


def disable_check_model_nan_inf(x, flag=0):
    return _OPS['disable_check_model_nan_inf'](x, flag=flag)


def dist(x, y, p=2.0):
    return _OPS['dist'](x, y, p=p)


def dist_concat(x, ring_id=0, nranks=1):
    raise _waiting_error('dist_concat')  # item 7


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level, refer_scale, rois_num=None, pixel_offset=False):
    return _OPS['distribute_fpn_proposals'](fpn_rois, min_level, max_level, refer_level, refer_scale, rois_num=rois_num, pixel_offset=pixel_offset)


def distributed_fused_lamb_init(param, grad, beta1=0.9, beta2=0.999, apply_weight_decay=(), alignment=128, rank=0, nranks=1):
    return _OPS['distributed_fused_lamb_init'](param, grad, beta1=beta1, beta2=beta2, apply_weight_decay=apply_weight_decay, alignment=alignment, rank=rank, nranks=nranks)


def divide(x, y):
    return _OPS['divide'](x, y)


def divide_scalar(x, scalar=1.0):
    return _OPS['divide_scalar'](x, scalar=scalar)


def dot(x, y):
    return _OPS['dot'](x, y)


def dpsgd(param, grad, learning_rate, clip=10.0, batch_size=16.0, sigma=1.0, seed=0):
    return _OPS['dpsgd'](param, grad, learning_rate, clip=clip, batch_size=batch_size, sigma=sigma, seed=seed)


def dropout(x, p=0.5, training=True, mode='upscale_in_train', seed=0):
    return _OPS['dropout'](x, p=p, training=training, mode=mode, seed=seed)


def dropout_nd(x, p=0.5, axis=None, seed=0, is_test=False, mode='upscale_in_train'):
    return _OPS['dropout_nd'](x, p=p, axis=axis, seed=seed, is_test=is_test, mode=mode)


def edit_distance(hyps, refs, hyp_lengths=None, ref_lengths=None, normalized=True):
    return _OPS['edit_distance'](hyps, refs, hyp_lengths=hyp_lengths, ref_lengths=ref_lengths, normalized=normalized)


def eig(x):
    return _OPS['eig'](x)


def eigh(x, UPLO='L'):
    return _OPS['eigh'](x, UPLO=UPLO)


def eigvals(x):
    return _OPS['eigvals'](x)


def eigvalsh(x, UPLO='L'):
    return _OPS['eigvalsh'](x, UPLO=UPLO)


def einsum(equation, *operands):
    return _OPS['einsum'](equation, *operands)


def elementwise_floordiv(x, y, axis=-1):
    return _OPS['elementwise_floordiv'](x, y, axis=axis)


def elementwise_max(x, y, axis=-1):
    return _OPS['elementwise_max'](x, y, axis=axis)


def elementwise_min(x, y, axis=-1):
    return _OPS['elementwise_min'](x, y, axis=axis)


def elementwise_mod(x, y, axis=-1):
    return _OPS['elementwise_mod'](x, y, axis=axis)


def elementwise_pow(x, y, axis=-1):
    return _OPS['elementwise_pow'](x, y, axis=axis)


def elementwise_rpow(x, y):
    return _OPS['elementwise_rpow'](x, y)


def elu(x, alpha=1.0):
    return _OPS['elu'](x, alpha=alpha)


def embedding(x, weight, padding_idx=None, sparse=False):
    return _OPS['embedding'](x, weight, padding_idx=padding_idx, sparse=sparse)


def empty(shape, dtype=None):
    return _OPS['empty'](shape, dtype=dtype)


def empty_like(x, dtype=None):
    return _OPS['empty_like'](x, dtype=dtype)


def enable_check_model_nan_inf(x, flag=1):
    return _OPS['enable_check_model_nan_inf'](x, flag=flag)


def equal(x, y):
    return _OPS['equal'](x, y)


def equal_all(x, y):
    return _OPS['equal_all'](x, y)


def erf(x):
    return _OPS['erf'](x)


def erfinv(x):
    return _OPS['erfinv'](x)


def exp(x):
    return _OPS['exp'](x)


def expand(x, shape):
    return _OPS['expand'](x, shape)


def expand_as(x, y):
    return _OPS['expand_as'](x, y)


def expand_as_v2(x, y=None, target_shape=None):
    return _OPS['expand_as_v2'](x, y=y, target_shape=target_shape)


def expm1(x):
    return _OPS['expm1'](x)


def exponential_(x, lam=1.0, seed=0):
    return _OPS['exponential_'](x, lam=lam, seed=seed)


def eye(num_rows, num_columns=None, dtype=None):
    return _OPS['eye'](num_rows, num_columns=num_columns, dtype=dtype)


def fake_channel_wise_dequantize_max_abs(x, scales, quant_bits=8, quant_axis=0):
    return _OPS['fake_channel_wise_dequantize_max_abs'](x, scales, quant_bits=quant_bits, quant_axis=quant_axis)


def fake_channel_wise_quantize_abs_max(x, bit_length=8, quant_axis=0):
    return _OPS['fake_channel_wise_quantize_abs_max'](x, bit_length=bit_length, quant_axis=quant_axis)


def fake_channel_wise_quantize_dequantize_abs_max(x, bit_length=8, quant_axis=0):
    return _OPS['fake_channel_wise_quantize_dequantize_abs_max'](x, bit_length=bit_length, quant_axis=quant_axis)


def fake_dequantize_max_abs(x, scale, max_range):
    return _OPS['fake_dequantize_max_abs'](x, scale, max_range)


def fake_quantize_abs_max(x, bit_length=8):
    return _OPS['fake_quantize_abs_max'](x, bit_length=bit_length)


def fake_quantize_dequantize_abs_max(x, scale, bit_length=8):
    raise _waiting_error('fake_quantize_dequantize_abs_max')  # item 9


def fake_quantize_dequantize_moving_average_abs_max(x, in_scale, moving_rate=0.9, bit_length=8):
    return _OPS['fake_quantize_dequantize_moving_average_abs_max'](x, in_scale, moving_rate=moving_rate, bit_length=bit_length)


def fake_quantize_moving_average_abs_max(x, in_scale, moving_rate=0.9, bit_length=8):
    return _OPS['fake_quantize_moving_average_abs_max'](x, in_scale, moving_rate=moving_rate, bit_length=bit_length)


def fake_quantize_range_abs_max(x, in_scale, window_size=10000, bit_length=8):
    return _OPS['fake_quantize_range_abs_max'](x, in_scale, window_size=window_size, bit_length=bit_length)


def fc(input, w, bias=None, in_num_col_dims=1, activation_type='', padding_weights=False):
    return _OPS['fc'](input, w, bias=bias, in_num_col_dims=in_num_col_dims, activation_type=activation_type, padding_weights=padding_weights)


def fetch_barrier(x, trainer_id=0, endpoints=('127.0.0.1:6164',)):
    raise _waiting_error('fetch_barrier')  # item 7


def fft_c2c(x, axes=(-1,), normalization='backward', forward=True):
    return _OPS['fft_c2c'](x, axes=axes, normalization=normalization, forward=forward)


def fft_c2r(x, axes=(-1,), normalization='backward', forward=False, last_dim_size=0):
    return _OPS['fft_c2r'](x, axes=axes, normalization=normalization, forward=forward, last_dim_size=last_dim_size)


def fft_r2c(x, axes=(-1,), normalization='backward', forward=True, onesided=True):
    return _OPS['fft_r2c'](x, axes=axes, normalization=normalization, forward=forward, onesided=onesided)


def fill(x, value=0.0):
    return _OPS['fill'](x, value=value)


def fill_diagonal(x, value=0.0, offset=0, wrap=False):
    return _OPS['fill_diagonal'](x, value=value, offset=offset, wrap=wrap)


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1):
    return _OPS['fill_diagonal_tensor'](x, y, offset=offset, dim1=dim1, dim2=dim2)


def flash_attn(q, k, v, fixed_seed_offset=None, attn_mask=None, dropout=0.0, causal=False, return_softmax=False):
    return _OPS['flash_attn'](q, k, v, fixed_seed_offset=fixed_seed_offset, attn_mask=attn_mask, dropout=dropout, causal=causal, return_softmax=return_softmax)


def flash_attn_qkvpacked(qkv, fixed_seed_offset=None, attn_mask=None, dropout=0.0, causal=False, return_softmax=False):
    return _OPS['flash_attn_qkvpacked'](qkv, fixed_seed_offset=fixed_seed_offset, attn_mask=attn_mask, dropout=dropout, causal=causal, return_softmax=return_softmax)


def flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k, fixed_seed_offset=None, attn_mask=None, max_seqlen_q=None, max_seqlen_k=None, scale=None, dropout=0.0, causal=False, return_softmax=False, is_test=False, rng_name=''):
    return _OPS['flash_attn_unpadded'](q, k, v, cu_seqlens_q, cu_seqlens_k, fixed_seed_offset=fixed_seed_offset, attn_mask=attn_mask, max_seqlen_q=max_seqlen_q, max_seqlen_k=max_seqlen_k, scale=scale, dropout=dropout, causal=causal, return_softmax=return_softmax, is_test=is_test, rng_name=rng_name)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k, fixed_seed_offset=None, attn_mask=None, max_seqlen_q=None, max_seqlen_k=None, scale=None, dropout=0.0, causal=False, return_softmax=False, is_test=False, rng_name=''):
    return _OPS['flash_attn_varlen_qkvpacked'](qkv, cu_seqlens_q, cu_seqlens_k, fixed_seed_offset=fixed_seed_offset, attn_mask=attn_mask, max_seqlen_q=max_seqlen_q, max_seqlen_k=max_seqlen_k, scale=scale, dropout=dropout, causal=causal, return_softmax=return_softmax, is_test=is_test, rng_name=rng_name)


def flashmask_attention(q, k, v, startend_row_indices, fixed_seed_offset=None, dropout=0.0, causal=False, return_softmax=False, is_test=False, rng_name=''):
    return _OPS['flashmask_attention'](q, k, v, startend_row_indices, fixed_seed_offset=fixed_seed_offset, dropout=dropout, causal=causal, return_softmax=return_softmax, is_test=is_test, rng_name=rng_name)


def flatten(x, start_axis=0, stop_axis=-1):
    return _OPS['flatten'](x, start_axis=start_axis, stop_axis=stop_axis)


def flatten2(x, axis=1):
    return _OPS['flatten2'](x, axis=axis)


def flip(x, axis):
    return _OPS['flip'](x, axis)


def floor(x):
    return _OPS['floor'](x)


def floor_divide(x, y):
    return _OPS['floor_divide'](x, y)


def fmax(x, y):
    return _OPS['fmax'](x, y)


def fmin(x, y):
    return _OPS['fmin'](x, y)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
    return _OPS['fold'](x, output_sizes, kernel_sizes, strides=strides, paddings=paddings, dilations=dilations)


def fp8_fp8_half_gemm_fused(x, y, bias=None, transpose_x=False, transpose_y=False, scale=1.0, output_dtype='float16', activation_type='identity'):
    return _OPS['fp8_fp8_half_gemm_fused'](x, y, bias=bias, transpose_x=transpose_x, transpose_y=transpose_y, scale=scale, output_dtype=output_dtype, activation_type=activation_type)


def frac(x):
    return _OPS['frac'](x)


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None, return_mask=False):
    return _OPS['fractional_max_pool2d'](x, output_size, kernel_size=kernel_size, random_u=random_u, return_mask=return_mask)


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None, return_mask=False):
    return _OPS['fractional_max_pool3d'](x, output_size, kernel_size=kernel_size, random_u=random_u, return_mask=return_mask)


def frame(x, frame_length, hop_length, axis=-1):
    return _OPS['frame'](x, frame_length, hop_length, axis=axis)


def frobenius_norm(x, axis=None, keepdim=False):
    return _OPS['frobenius_norm'](x, axis=axis, keepdim=keepdim)


def ftrl(param, squared_accumulator, linear_accumulator, grad, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5):
    return _OPS['ftrl'](param, squared_accumulator, linear_accumulator, grad, learning_rate, l1=l1, l2=l2, lr_power=lr_power)


def ftrl_(param, squared_accum, linear_accum, grad, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5):
    return _OPS['ftrl_'](param, squared_accum, linear_accum, grad, learning_rate, l1=l1, l2=l2, lr_power=lr_power)


def full(shape, fill_value, dtype=None):
    return _OPS['full'](shape, fill_value, dtype=dtype)


def full_(output, shape=None, value=0.0, dtype=None):
    raise _waiting_error('full_')  # item 7


def full_batch_size_like(input, shape, value=0.0, input_dim_idx=0, output_dim_idx=0, dtype='float32'):
    return _OPS['full_batch_size_like'](input, shape, value=value, input_dim_idx=input_dim_idx, output_dim_idx=output_dim_idx, dtype=dtype)


def full_int_array(value, dtype='int64'):
    raise _waiting_error('full_int_array')  # item 7


def full_like(x, fill_value, dtype=None):
    return _OPS['full_like'](x, fill_value, dtype=dtype)


def full_with_tensor(value, shape, dtype=None):
    raise _waiting_error('full_with_tensor')  # item 7


def fused_attention(x, qkv_weight, linear_weight, qkv_bias=None, linear_bias=None, pre_ln_scale=None, pre_ln_bias=None, ln_scale=None, ln_bias=None, num_heads=None, pre_layer_norm=False, epsilon=1e-05, attn_dropout_rate=0.0, dropout_rate=0.0, attn_mask=None, training=False):
    return _OPS['fused_attention'](x, qkv_weight, linear_weight, qkv_bias=qkv_bias, linear_bias=linear_bias, pre_ln_scale=pre_ln_scale, pre_ln_bias=pre_ln_bias, ln_scale=ln_scale, ln_bias=ln_bias, num_heads=num_heads, pre_layer_norm=pre_layer_norm, epsilon=epsilon, attn_dropout_rate=attn_dropout_rate, dropout_rate=dropout_rate, attn_mask=attn_mask, training=training)


def fused_batch_norm_act(x, scale, bias, mean, variance, momentum=0.9, epsilon=1e-05, act_type='relu'):
    return _OPS['fused_batch_norm_act'](x, scale, bias, mean, variance, momentum=momentum, epsilon=epsilon, act_type=act_type)


def fused_bias_act(x, bias=None, act_method='gelu'):
    return _OPS['fused_bias_act'](x, bias=bias, act_method=act_method)


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None, ln_scale=None, ln_bias=None, dropout_rate=0.0, ln_epsilon=1e-05, training=False, seed=0):
    return _OPS['fused_bias_dropout_residual_layer_norm'](x, residual, bias=bias, ln_scale=ln_scale, ln_bias=ln_bias, dropout_rate=dropout_rate, ln_epsilon=ln_epsilon, training=training, seed=seed)


def fused_bias_residual_layernorm(x, bias=None, residual=None, norm_weight=None, norm_bias=None, epsilon=1e-05, residual_alpha=1.0, begin_norm_axis=-1, quant_scale=-1.0):
    return _OPS['fused_bias_residual_layernorm'](x, bias=bias, residual=residual, norm_weight=norm_weight, norm_bias=norm_bias, epsilon=epsilon, residual_alpha=residual_alpha, begin_norm_axis=begin_norm_axis, quant_scale=quant_scale)


def fused_bn_add_activation(x, z, scale, bias, mean, variance, momentum=0.9, epsilon=1e-05, act_type='relu'):
    return _OPS['fused_bn_add_activation'](x, z, scale, bias, mean, variance, momentum=momentum, epsilon=epsilon, act_type=act_type)


def fused_conv2d_add_act(input, filter, bias=None, residual_data=None, strides=(1, 1), paddings=(0, 0), dilations=(1, 1), groups=1, activation='relu', padding_algorithm='EXPLICIT', split_channels=()):
    return _OPS['fused_conv2d_add_act'](input, filter, bias=bias, residual_data=residual_data, strides=strides, paddings=paddings, dilations=dilations, groups=groups, activation=activation, padding_algorithm=padding_algorithm, split_channels=split_channels)


def fused_dconv_drelu_dbn(grad_output, weight, grad_output_add, residual_input, bn1_eqscale, bn1_eqbias, conv_input, bn1_mean, bn1_inv_std, bn1_gamma, bn1_beta, bn1_input, bn2_mean=None, bn2_inv_std=None, bn2_gamma=None, bn2_beta=None, bn2_input=None, paddings=(0, 0), dilations=(1, 1), strides=(1, 1), padding_algorithm='EXPLICIT', groups=1, data_format='NHWC', fuse_shortcut=False, fuse_dual=False, fuse_add=False, exhaustive_search=False):
    return _OPS['fused_dconv_drelu_dbn'](grad_output, weight, grad_output_add, residual_input, bn1_eqscale, bn1_eqbias, conv_input, bn1_mean, bn1_inv_std, bn1_gamma, bn1_beta, bn1_input, bn2_mean=bn2_mean, bn2_inv_std=bn2_inv_std, bn2_gamma=bn2_gamma, bn2_beta=bn2_beta, bn2_input=bn2_input, paddings=paddings, dilations=dilations, strides=strides, padding_algorithm=padding_algorithm, groups=groups, data_format=data_format, fuse_shortcut=fuse_shortcut, fuse_dual=fuse_dual, fuse_add=fuse_add, exhaustive_search=exhaustive_search)


def fused_dot_product_attention(q, k, v, mask=None, scaling_factor=None, dropout_probability=0.0, is_training=False, is_causal_masking=False):
    return _OPS['fused_dot_product_attention'](q, k, v, mask=mask, scaling_factor=scaling_factor, dropout_probability=dropout_probability, is_training=is_training, is_causal_masking=is_causal_masking)


def fused_dropout_add(x, y, p=0.5, is_test=False, mode='upscale_in_train', seed=0, fix_seed=False):
    return _OPS['fused_dropout_add'](x, y, p=p, is_test=is_test, mode=mode, seed=seed, fix_seed=fix_seed)


def fused_elementwise_add(x, y, axis=-1, fuse_alpha=None, fuse_beta=None, fused_unary_fn='identity'):
    return _OPS['fused_elementwise_add'](x, y, axis=axis, fuse_alpha=fuse_alpha, fuse_beta=fuse_beta, fused_unary_fn=fused_unary_fn)


def fused_elementwise_div(x, y, axis=-1, fuse_alpha=None, fused_unary_fn='identity'):
    return _OPS['fused_elementwise_div'](x, y, axis=axis, fuse_alpha=fuse_alpha, fused_unary_fn=fused_unary_fn)


def fused_elementwise_mul(x, y, axis=-1, fuse_alpha=None, fused_unary_fn='identity'):
    return _OPS['fused_elementwise_mul'](x, y, axis=axis, fuse_alpha=fuse_alpha, fused_unary_fn=fused_unary_fn)


def fused_elementwise_sub(x, y, axis=-1, fuse_alpha=None, fused_unary_fn='identity'):
    return _OPS['fused_elementwise_sub'](x, y, axis=axis, fuse_alpha=fuse_alpha, fused_unary_fn=fused_unary_fn)


def fused_elemwise_activation(x, y, functor_list=('elementwise_add', 'relu'), axis=-1, scale=0.0, save_intermediate_out=False):
    return _OPS['fused_elemwise_activation'](x, y, functor_list=functor_list, axis=axis, scale=scale, save_intermediate_out=save_intermediate_out)


def fused_elemwise_add_activation(x, y, functor_list=('elementwise_add', 'relu'), axis=-1, scale=1.0, save_intermediate_out=False):
    return _OPS['fused_elemwise_add_activation'](x, y, functor_list=functor_list, axis=axis, scale=scale, save_intermediate_out=save_intermediate_out)


def fused_embedding_eltwise_layernorm(ids, embs, bias=None, scale=None, epsilon=1e-05):
    return _OPS['fused_embedding_eltwise_layernorm'](ids, embs, bias=bias, scale=scale, epsilon=epsilon)


def fused_embedding_fc_lstm(ids, embeddings, weight_h, bias, h0, c0, lod, use_peepholes=False, is_reverse=False, gate_activation='sigmoid', cell_activation='tanh', candidate_activation='tanh'):
    return _OPS['fused_embedding_fc_lstm'](ids, embeddings, weight_h, bias, h0, c0, lod, use_peepholes=use_peepholes, is_reverse=is_reverse, gate_activation=gate_activation, cell_activation=cell_activation, candidate_activation=candidate_activation)


def fused_fc_elementwise_layernorm(x, w, y, bias0=None, scale=None, bias1=None, epsilon=1e-05, begin_norm_axis=-1, activation_type=''):
    return _OPS['fused_fc_elementwise_layernorm'](x, w, y, bias0=bias0, scale=scale, bias1=bias1, epsilon=epsilon, begin_norm_axis=begin_norm_axis, activation_type=activation_type)


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None, linear2_bias=None, ln1_scale=None, ln1_bias=None, ln2_scale=None, ln2_bias=None, dropout1_rate=0.5, dropout2_rate=0.5, activation='relu', ln1_epsilon=1e-05, ln2_epsilon=1e-05, pre_layer_norm=False, training=False):
    return _OPS['fused_feedforward'](x, linear1_weight, linear2_weight, linear1_bias=linear1_bias, linear2_bias=linear2_bias, ln1_scale=ln1_scale, ln1_bias=ln1_bias, ln2_scale=ln2_scale, ln2_bias=ln2_bias, dropout1_rate=dropout1_rate, dropout2_rate=dropout2_rate, activation=activation, ln1_epsilon=ln1_epsilon, ln2_epsilon=ln2_epsilon, pre_layer_norm=pre_layer_norm, training=training)


def fused_linear(x, weight, bias=None, transpose_weight=False):
    return _OPS['fused_linear'](x, weight, bias=bias, transpose_weight=transpose_weight)


def fused_linear_param_grad_add(x, dout, dweight=None, dbias=None, multi_precision=True, has_bias=True):
    return _OPS['fused_linear_param_grad_add'](x, dout, dweight=dweight, dbias=dbias, multi_precision=multi_precision, has_bias=has_bias)


def fused_moe(x, gate_weight, ffn1_weight, ffn1_scale=None, ffn1_bias=None, ffn2_weight=None, ffn2_scale=None, ffn2_bias=None, quant_method='None', moe_topk=2, norm_topk_prob=True):
    return _OPS['fused_moe'](x, gate_weight, ffn1_weight, ffn1_scale=ffn1_scale, ffn1_bias=ffn1_bias, ffn2_weight=ffn2_weight, ffn2_scale=ffn2_scale, ffn2_bias=ffn2_bias, quant_method=quant_method, moe_topk=moe_topk, norm_topk_prob=norm_topk_prob)


def fused_multi_transformer_(x, ln_scales, ln_biases, qkv_weights, qkv_biases, linear_weights, linear_biases, ffn_ln_scales, ffn_ln_biases, ffn1_weights, ffn1_biases, ffn2_weights, ffn2_biases, pre_layer_norm=True, epsilon=1e-05, residual_alpha=1.0, cache_kvs=None, beam_offset=None, pre_caches=None, seq_lens=None, rotary_embs=None, time_step=None, attn_mask=None, dropout_rate=0.0, rotary_emb_dims=0, activation='gelu', training=False, mode='upscale_in_train', trans_qkvw=True, ring_id=-1, norm_type='layernorm', use_neox_rotary_style=False, gqa_group_size=-1):
    return _OPS['fused_multi_transformer_'](x, ln_scales, ln_biases, qkv_weights, qkv_biases, linear_weights, linear_biases, ffn_ln_scales, ffn_ln_biases, ffn1_weights, ffn1_biases, ffn2_weights, ffn2_biases, pre_layer_norm=pre_layer_norm, epsilon=epsilon, residual_alpha=residual_alpha, cache_kvs=cache_kvs, beam_offset=beam_offset, pre_caches=pre_caches, seq_lens=seq_lens, rotary_embs=rotary_embs, time_step=time_step, attn_mask=attn_mask, dropout_rate=dropout_rate, rotary_emb_dims=rotary_emb_dims, activation=activation, training=training, mode=mode, trans_qkvw=trans_qkvw, ring_id=ring_id, norm_type=norm_type, use_neox_rotary_style=use_neox_rotary_style, gqa_group_size=gqa_group_size)


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-06, begin_norm_axis=-1):
    return _OPS['fused_rms_norm'](x, norm_weight, norm_bias=norm_bias, epsilon=epsilon, begin_norm_axis=begin_norm_axis)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None, position_ids=None, use_neox_rotary_style=True, time_major=False, rotary_emb_base=10000.0):
    return _OPS['fused_rotary_position_embedding'](q, k=k, v=v, sin=sin, cos=cos, position_ids=position_ids, use_neox_rotary_style=use_neox_rotary_style, time_major=time_major, rotary_emb_base=rotary_emb_base)


def fused_scale_bias_add_relu(x1, scale1, bias1, x2, scale2=None, bias2=None, fuse_dual=False, exhaustive_search=False):
    return _OPS['fused_scale_bias_add_relu'](x1, scale1, bias1, x2, scale2=scale2, bias2=bias2, fuse_dual=fuse_dual, exhaustive_search=exhaustive_search)


def fused_scale_bias_relu_conv_bn(x, w, scale, bias, bn_scale, bn_bias, input_running_mean, input_running_var, paddings=(0, 0), dilations=(1, 1), strides=(1, 1), padding_algorithm='EXPLICIT', groups=1, data_format='NHWC', momentum=0.9, epsilon=1e-05, fuse_prologue=True, exhaustive_search=False, accumulation_count=0):
    return _OPS['fused_scale_bias_relu_conv_bn'](x, w, scale, bias, bn_scale, bn_bias, input_running_mean, input_running_var, paddings=paddings, dilations=dilations, strides=strides, padding_algorithm=padding_algorithm, groups=groups, data_format=data_format, momentum=momentum, epsilon=epsilon, fuse_prologue=fuse_prologue, exhaustive_search=exhaustive_search, accumulation_count=accumulation_count)


def fused_seqpool_cvm(x, cvm, lod, pooltype='SUM', pad_value=0.0, use_cvm=True, cvm_offset=2):
    return _OPS['fused_seqpool_cvm'](x, cvm, lod, pooltype=pooltype, pad_value=pad_value, use_cvm=use_cvm, cvm_offset=cvm_offset)


def fused_softmax_mask(x, mask):
    return _OPS['fused_softmax_mask'](x, mask)


def fused_softmax_mask_upper_triangle(x):
    return _OPS['fused_softmax_mask_upper_triangle'](x)


def fused_token_prune(attn, x, mask, new_mask, keep_first_token=True, keep_order=False):
    return _OPS['fused_token_prune'](attn, x, mask, new_mask, keep_first_token=keep_first_token, keep_order=keep_order)


def fusion_gru(x, weight_x, weight_h, h0=None, bias=None, activation='tanh', gate_activation='sigmoid', is_reverse=False, origin_mode=False):
    return _OPS['fusion_gru'](x, weight_x, weight_h, h0=h0, bias=bias, activation=activation, gate_activation=gate_activation, is_reverse=is_reverse, origin_mode=origin_mode)


def fusion_lstm(x, weight_x, weight_h, h0=None, c0=None, bias=None, activation='tanh', gate_activation='sigmoid', cell_activation='tanh', is_reverse=False):
    return _OPS['fusion_lstm'](x, weight_x, weight_h, h0=h0, c0=c0, bias=bias, activation=activation, gate_activation=gate_activation, cell_activation=cell_activation, is_reverse=is_reverse)


def fusion_repeated_fc_relu(x, w, bias):
    return _OPS['fusion_repeated_fc_relu'](x, w, bias)


def fusion_seqconv_eltadd_relu(x, filter, bias, lod, context_length=3, context_start=0, context_stride=1):
    return _OPS['fusion_seqconv_eltadd_relu'](x, filter, bias, lod, context_length=context_length, context_start=context_start, context_stride=context_stride)


def fusion_seqexpand_concat_fc(x, fc_weight, fc_bias, lod, fc_activation='identity'):
    return _OPS['fusion_seqexpand_concat_fc'](x, fc_weight, fc_bias, lod, fc_activation=fc_activation)


def fusion_seqpool_concat(x, lod, pooltype='SUM', axis=1):
    return _OPS['fusion_seqpool_concat'](x, lod, pooltype=pooltype, axis=axis)


def fusion_seqpool_cvm_concat(x, cvm, lod, pooltype='SUM', use_cvm=True, axis=1):
    return _OPS['fusion_seqpool_cvm_concat'](x, cvm, lod, pooltype=pooltype, use_cvm=use_cvm, axis=axis)


def fusion_squared_mat_sub(x, y, scalar=1.0):
    return _OPS['fusion_squared_mat_sub'](x, y, scalar=scalar)


def fusion_transpose_flatten_concat(x, trans_axis, flatten_axis, concat_axis):
    return _OPS['fusion_transpose_flatten_concat'](x, trans_axis, flatten_axis, concat_axis)


def gammaincc(x, y):
    return _OPS['gammaincc'](x, y)


def gammaln(x):
    return _OPS['gammaln'](x)


def gather(x, index, axis=0):
    return _OPS['gather'](x, index, axis=axis)


def gather_nd(x, index):
    return _OPS['gather_nd'](x, index)


def gather_tree(ids, parents):
    return _OPS['gather_tree'](ids, parents)


def gaussian(shape, mean=0.0, std=1.0, dtype=None, seed=0):
    return _OPS['gaussian'](shape, mean=mean, std=std, dtype=dtype, seed=seed)


def gaussian_inplace(x, mean=0.0, std=1.0, seed=0):
    return _OPS['gaussian_inplace'](x, mean=mean, std=std, seed=seed)


def gaussian_random(shape=(), mean=0.0, std=1.0, seed=0, dtype='float32'):
    return _OPS['gaussian_random'](shape=shape, mean=mean, std=std, seed=seed, dtype=dtype)


def gcd(x, y):
    return _OPS['gcd'](x, y)


def gelu(x, approximate=False):
    return _OPS['gelu'](x, approximate=approximate)


def gemm_epilogue(x, y, bias=None, trans_x=False, trans_y=False, activation='none'):
    return _OPS['gemm_epilogue'](x, y, bias=bias, trans_x=trans_x, trans_y=trans_y, activation=activation)


def generate_proposals(scores, bbox_deltas, im_shape, anchors, variances, pre_nms_top_n=6000, post_nms_top_n=1000, nms_thresh=0.5, min_size=0.1, eta=1.0, pixel_offset=False):
    return _OPS['generate_proposals'](scores, bbox_deltas, im_shape, anchors, variances, pre_nms_top_n=pre_nms_top_n, post_nms_top_n=post_nms_top_n, nms_thresh=nms_thresh, min_size=min_size, eta=eta, pixel_offset=pixel_offset)


def getitem(x, idx):
    return _OPS['getitem'](x, idx)


def global_gather(x, local_count, global_count, ring_id=0, use_calc_stream=True, group=None):
    raise _waiting_error('global_gather')  # item 7


def global_scatter(x, local_count, global_count, ring_id=0, use_calc_stream=True, group=None):
    raise _waiting_error('global_scatter')  # item 7


def glu(x, axis=-1):
    return _OPS['glu'](x, axis=axis)


def grad_add(x, y):
    return _OPS['grad_add'](x, y)


def graph_khop_sampler(row, colptr, x, eids=None, sample_sizes=(), return_eids=False, seed=0):
    return _OPS['graph_khop_sampler'](row, colptr, x, eids=eids, sample_sizes=sample_sizes, return_eids=return_eids, seed=seed)


def graph_sample_neighbors(row, colptr, x, eids=None, perm_buffer=None, sample_size=-1, return_eids=False, flag_perm_buffer=False, seed=0):
    return _OPS['graph_sample_neighbors'](row, colptr, x, eids=eids, perm_buffer=perm_buffer, sample_size=sample_size, return_eids=return_eids, flag_perm_buffer=flag_perm_buffer, seed=seed)


def graph_send_recv(x, src_index, dst_index, reduce_op='sum', out_size=None):
    raise _waiting_error('graph_send_recv')  # item 9


def graph_send_ue_recv(x, y, src_index, dst_index, message_op='add', reduce_op='sum', out_size=None):
    raise _waiting_error('graph_send_ue_recv')  # item 9


def graph_send_uv(x, y, src_index, dst_index, message_op='add'):
    raise _waiting_error('graph_send_uv')  # item 9


def greater_equal(x, y):
    return _OPS['greater_equal'](x, y)


def greater_than(x, y):
    return _OPS['greater_than'](x, y)


def grid_sample(x, grid, mode='bilinear', padding_mode='zeros', align_corners=True):
    return _OPS['grid_sample'](x, grid, mode=mode, padding_mode=padding_mode, align_corners=align_corners)


def group_norm(x, weight=None, bias=None, epsilon=1e-05, groups=1, data_format='NCHW'):
    return _OPS['group_norm'](x, weight=weight, bias=bias, epsilon=epsilon, groups=groups, data_format=data_format)


def gru(x, init_h, w_ih, w_hh, b_ih=None, b_hh=None, is_bidirec=False, num_layers=1, time_major=False):
    return _OPS['gru'](x, init_h, w_ih, w_hh, b_ih=b_ih, b_hh=b_hh, is_bidirec=is_bidirec, num_layers=num_layers, time_major=time_major)


def gru_unit(input, hidden_prev, weight, bias=None, activation=2, gate_activation=1, origin_mode=False):
    return _OPS['gru_unit'](input, hidden_prev, weight, bias=bias, activation=activation, gate_activation=gate_activation, origin_mode=origin_mode)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1):
    return _OPS['gumbel_softmax'](x, temperature=temperature, hard=hard, axis=axis)


def hardshrink(x, threshold=0.5):
    return _OPS['hardshrink'](x, threshold=threshold)


def hardsigmoid(x, slope=0.1666667, offset=0.5):
    return _OPS['hardsigmoid'](x, slope=slope, offset=offset)


def hardswish(x):
    return _OPS['hardswish'](x)


def hardtanh(x, min=-1.0, max=1.0):
    return _OPS['hardtanh'](x, min=min, max=max)


def hash(x, num_hash=1, mod_by=100000, runtime_shape=True):
    return _OPS['hash'](x, num_hash=num_hash, mod_by=mod_by, runtime_shape=runtime_shape)


def heaviside(x, y):
    return _OPS['heaviside'](x, y)


def hinge_loss(logits, labels):
    return _OPS['hinge_loss'](logits, labels)


def histogram(x, bins=100, min=0, max=0, weight=None, density=False):
    return _OPS['histogram'](x, bins=bins, min=min, max=max, weight=weight, density=density)


def householder_product(x, tau):
    return _OPS['householder_product'](x, tau)


def hsigmoid_loss(x, label, num_classes, weight, bias=None, path_table=None, path_code=None, is_sparse=False):
    return _OPS['hsigmoid_loss'](x, label, num_classes, weight, bias=bias, path_table=path_table, path_code=path_code, is_sparse=is_sparse)


def huber_loss(input, label, delta=1.0):
    return _OPS['huber_loss'](input, label, delta=delta)


def hypot(x, y):
    return _OPS['hypot'](x, y)


def i0(x):
    return _OPS['i0'](x)


def i0e(x):
    return _OPS['i0e'](x)


def i1(x):
    return _OPS['i1'](x)


def i1e(x):
    return _OPS['i1e'](x)


def identity_loss(x, reduction=1):
    return _OPS['identity_loss'](x, reduction=reduction)


def im2sequence(x, kernels, strides=(1, 1), paddings=(0, 0, 0, 0), out_stride=(1, 1)):
    return _OPS['im2sequence'](x, kernels, strides=strides, paddings=paddings, out_stride=out_stride)


def imag(x):
    return _OPS['imag'](x)


def increment(x, value=1.0):
    return _OPS['increment'](x, value=value)


def index_add(x, index, axis, value):
    return _OPS['index_add'](x, index, axis, value)


def index_put(x, indices, value, accumulate=False):
    return _OPS['index_put'](x, indices, value, accumulate=accumulate)


def index_sample(x, index):
    return _OPS['index_sample'](x, index)


def index_select(x, index, axis=0):
    return _OPS['index_select'](x, index, axis=axis)


def index_select_strided(x, index, axis=0):
    return _OPS['index_select_strided'](x, index, axis=axis)


def indices(x):
    raise _waiting_error('indices')  # item 9


def inner(x, y):
    return _OPS['inner'](x, y)


def instance_norm(x, weight=None, bias=None, epsilon=1e-05):
    return _OPS['instance_norm'](x, weight=weight, bias=bias, epsilon=epsilon)


def interpolate_bilinear(x, out_hw, align_corners=False, data_format='NCHW'):
    return _OPS['interpolate_bilinear'](x, out_hw, align_corners=align_corners, data_format=data_format)


def interpolate_nearest(x, out_hw, data_format='NCHW'):
    return _OPS['interpolate_nearest'](x, out_hw, data_format=data_format)


def inverse(x):
    return _OPS['inverse'](x)


def iou_similarity(x, y, box_normalized=True):
    return _OPS['iou_similarity'](x, y, box_normalized=box_normalized)


def is_empty(x):
    return _OPS['is_empty'](x)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return _OPS['isclose'](x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def isfinite(x):
    return _OPS['isfinite'](x)


def isinf(x):
    return _OPS['isinf'](x)


def isnan(x):
    return _OPS['isnan'](x)


def kl_div(x, target, reduction='mean', log_target=False):
    return _OPS['kl_div'](x, target, reduction=reduction, log_target=log_target)


def kldiv_loss(x, target, reduction='mean', log_target=False):
    return _OPS['kldiv_loss'](x, target, reduction=reduction, log_target=log_target)


def kron(x, y):
    return _OPS['kron'](x, y)


def kthvalue(x, k, axis=-1, keepdim=False):
    return _OPS['kthvalue'](x, k, axis=axis, keepdim=keepdim)


def l1_norm(x):
    return _OPS['l1_norm'](x)


def label_smooth(label, prior_dist=None, epsilon=0.1):
    return _OPS['label_smooth'](label, prior_dist=prior_dist, epsilon=epsilon)


def lamb_(param, grad, learning_rate, moment1, moment2, beta1_pow, beta2_pow, weight_decay=0.01, beta1=0.9, beta2=0.999, epsilon=1e-06):
    return _OPS['lamb_'](param, grad, learning_rate, moment1, moment2, beta1_pow, beta2_pow, weight_decay=weight_decay, beta1=beta1, beta2=beta2, epsilon=epsilon)


def layer_norm(x, weight=None, bias=None, epsilon=1e-05, begin_norm_axis=-1):
    return _OPS['layer_norm'](x, weight=weight, bias=bias, epsilon=epsilon, begin_norm_axis=begin_norm_axis)


def lcm(x, y):
    return _OPS['lcm'](x, y)


def ldexp(x, y):
    return _OPS['ldexp'](x, y)


def leaky_relu(x, negative_slope=0.01):
    return _OPS['leaky_relu'](x, negative_slope=negative_slope)


def legacy_bilinear_interp(x, out_h=0, out_w=0, align_corners=True, align_mode=1, data_format='NCHW'):
    return _OPS['legacy_bilinear_interp'](x, out_h=out_h, out_w=out_w, align_corners=align_corners, align_mode=align_mode, data_format=data_format)


def legacy_crop(x, shape, offsets=None):
    return _OPS['legacy_crop'](x, shape, offsets=offsets)


def legacy_expand(x, expand_times):
    return _OPS['legacy_expand'](x, expand_times)


def legacy_generate_proposals(scores, bbox_deltas, im_info, anchors, variances, pre_nms_top_n=6000, post_nms_top_n=1000, nms_thresh=0.5, min_size=0.1, eta=1.0):
    return _OPS['legacy_generate_proposals'](scores, bbox_deltas, im_info, anchors, variances, pre_nms_top_n=pre_nms_top_n, post_nms_top_n=post_nms_top_n, nms_thresh=nms_thresh, min_size=min_size, eta=eta)


def legacy_nearest_interp(x, out_h=0, out_w=0, align_corners=True, data_format='NCHW'):
    return _OPS['legacy_nearest_interp'](x, out_h=out_h, out_w=out_w, align_corners=align_corners, data_format=data_format)


def lerp(x, y, weight):
    return _OPS['lerp'](x, y, weight)


def less_equal(x, y):
    return _OPS['less_equal'](x, y)


def less_than(x, y):
    return _OPS['less_than'](x, y)


def lgamma(x):
    return _OPS['lgamma'](x)


def limit_by_capacity(expert_count, capacity, n_worker=1):
    return _OPS['limit_by_capacity'](expert_count, capacity, n_worker=n_worker)


def linear(x, weight, bias=None):
    return _OPS['linear'](x, weight, bias=bias)


def linear_interp(x, out_w, align_corners=True, align_mode=1):
    return _OPS['linear_interp'](x, out_w, align_corners=align_corners, align_mode=align_mode)


def linspace(start, stop, num, dtype=None):
    return _OPS['linspace'](start, stop, num, dtype=dtype)


def llm_int8_linear(x, weight, bias=None, weight_scale=None, threshold=6.0):
    return _OPS['llm_int8_linear'](x, weight, bias=bias, weight_scale=weight_scale, threshold=threshold)


def local_response_norm(x, size=5, alpha=0.0001, beta=0.75, k=1.0, data_format='NCHW'):
    return _OPS['local_response_norm'](x, size=size, alpha=alpha, beta=beta, k=k, data_format=data_format)


def log(x):
    return _OPS['log'](x)


def log10(x):
    return _OPS['log10'](x)


def log1p(x):
    return _OPS['log1p'](x)


def log2(x):
    return _OPS['log2'](x)


def log_loss(input, label, epsilon=0.0001):
    return _OPS['log_loss'](input, label, epsilon=epsilon)


def log_sigmoid(x):
    return _OPS['log_sigmoid'](x)


def log_softmax(x, axis=-1):
    return _OPS['log_softmax'](x, axis=axis)


def logaddexp(x, y):
    return _OPS['logaddexp'](x, y)


def logcumsumexp(x, axis=-1, flatten=False):
    return _OPS['logcumsumexp'](x, axis=axis, flatten=flatten)


def logical_and(x, y):
    return _OPS['logical_and'](x, y)


def logical_not(x):
    return _OPS['logical_not'](x)


def logical_or(x, y):
    return _OPS['logical_or'](x, y)


def logical_xor(x, y):
    return _OPS['logical_xor'](x, y)


def logit(x, eps=None):
    return _OPS['logit'](x, eps=eps)


def logsigmoid(x):
    return _OPS['logsigmoid'](x)


def logspace(start, stop, num, base=10.0, dtype=None):
    return _OPS['logspace'](start, stop, num, base=base, dtype=dtype)


def logsumexp(x, axis=None, keepdim=False):
    return _OPS['logsumexp'](x, axis=axis, keepdim=keepdim)


def lookup_table(w, ids, padding_idx=-1, start_index=0):
    return _OPS['lookup_table'](w, ids, padding_idx=padding_idx, start_index=start_index)


def lookup_table_dequant(w, ids, padding_idx=-1):
    return _OPS['lookup_table_dequant'](w, ids, padding_idx=padding_idx)


def lower(x, use_utf8_encoding=False):
    return _OPS['lower'](x, use_utf8_encoding=use_utf8_encoding)


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0, ceil_mode=False, data_format='NCHW'):
    return _OPS['lp_pool2d'](x, norm_type, kernel_size, stride=stride, padding=padding, ceil_mode=ceil_mode, data_format=data_format)


def lrn(x, n=5, k=2.0, alpha=0.0001, beta=0.75, data_format='NCHW'):
    return _OPS['lrn'](x, n=n, k=k, alpha=alpha, beta=beta, data_format=data_format)


def lstm(x, init_h, init_c, w_ih, w_hh, b_ih=None, b_hh=None, is_bidirec=False, num_layers=1, time_major=False):
    return _OPS['lstm'](x, init_h, init_c, w_ih, w_hh, b_ih=b_ih, b_hh=b_hh, is_bidirec=is_bidirec, num_layers=num_layers, time_major=time_major)


def lstsq(x, y, rcond=None, driver=None):
    return _OPS['lstsq'](x, y, rcond=rcond, driver=driver)


def lu(x, pivot=True):
    return _OPS['lu'](x, pivot=pivot)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True):
    return _OPS['lu_unpack'](x, y, unpack_ludata=unpack_ludata, unpack_pivots=unpack_pivots)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5, margin3=0.0, scale=64.0, return_softmax=False):
    return _OPS['margin_cross_entropy'](logits, label, margin1=margin1, margin2=margin2, margin3=margin3, scale=scale, return_softmax=return_softmax)


def mask_as(x, mask):
    raise _waiting_error('mask_as')  # item 9


def masked_fill(x, mask, value):
    return _OPS['masked_fill'](x, mask, value)


def masked_matmul(x, y, mask):
    raise _waiting_error('masked_matmul')  # item 9


def masked_multihead_attention_(x, cache_kv=None, bias=None, src_mask=None, cum_offsets=None, sequence_lengths=None, rotary_tensor=None, beam_cache_offset=None, qkv_out_scale=None, out_shift=None, out_smooth=None, seq_len=1, rotary_emb_dims=0, use_neox_rotary_style=False, compute_dtype='default', out_scale=-1.0, quant_round_type=1, quant_max_bound=127.0, quant_min_bound=-127.0):
    return _OPS['masked_multihead_attention_'](x, cache_kv=cache_kv, bias=bias, src_mask=src_mask, cum_offsets=cum_offsets, sequence_lengths=sequence_lengths, rotary_tensor=rotary_tensor, beam_cache_offset=beam_cache_offset, qkv_out_scale=qkv_out_scale, out_shift=out_shift, out_smooth=out_smooth, seq_len=seq_len, rotary_emb_dims=rotary_emb_dims, use_neox_rotary_style=use_neox_rotary_style, compute_dtype=compute_dtype, out_scale=out_scale, quant_round_type=quant_round_type, quant_max_bound=quant_max_bound, quant_min_bound=quant_min_bound)


def masked_select(x, mask):
    return _OPS['masked_select'](x, mask)


def match_matrix_tensor(x, y, w, x_lod, y_lod, dim_t=1):
    return _OPS['match_matrix_tensor'](x, y, w, x_lod, y_lod, dim_t=dim_t)


def matmul(x, y, transpose_x=False, transpose_y=False):
    return _OPS['matmul'](x, y, transpose_x=transpose_x, transpose_y=transpose_y)


def matmul_with_flatten(x, y, x_num_col_dims=1, y_num_col_dims=1):
    return _OPS['matmul_with_flatten'](x, y, x_num_col_dims=x_num_col_dims, y_num_col_dims=y_num_col_dims)


def matrix_nms(bboxes, scores, score_threshold=0.05, post_threshold=0.0, nms_top_k=400, keep_top_k=200, use_gaussian=False, gaussian_sigma=2.0, background_label=0, normalized=True):
    return _OPS['matrix_nms'](bboxes, scores, score_threshold=score_threshold, post_threshold=post_threshold, nms_top_k=nms_top_k, keep_top_k=keep_top_k, use_gaussian=use_gaussian, gaussian_sigma=gaussian_sigma, background_label=background_label, normalized=normalized)


def matrix_power(x, n):
    return _OPS['matrix_power'](x, n)


def matrix_rank(x, tol=None, hermitian=False):
    return _OPS['matrix_rank'](x, tol=tol, hermitian=hermitian)


def matrix_rank_atol_rtol(x, atol=None, rtol=None, hermitian=False):
    return _OPS['matrix_rank_atol_rtol'](x, atol=atol, rtol=rtol, hermitian=hermitian)


def matrix_rank_tol(x, tol=None, use_default_tol=True, hermitian=False):
    return _OPS['matrix_rank_tol'](x, tol=tol, use_default_tol=use_default_tol, hermitian=hermitian)


def max(x, axis=None, keepdim=False):
    return _OPS['max'](x, axis=axis, keepdim=keepdim)


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False, data_format='NCL'):
    return _OPS['max_pool1d'](x, kernel_size, stride=stride, padding=padding, ceil_mode=ceil_mode, data_format=data_format)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, data_format='NCHW'):
    return _OPS['max_pool2d'](x, kernel_size, stride=stride, padding=padding, ceil_mode=ceil_mode, data_format=data_format)


def max_pool2d_v2(x, kernel_size, stride=None, padding=0, data_format='NCHW', global_pooling=False, adaptive=False, ceil_mode=False):
    return _OPS['max_pool2d_v2'](x, kernel_size, stride=stride, padding=padding, data_format=data_format, global_pooling=global_pooling, adaptive=adaptive, ceil_mode=ceil_mode)


def max_pool2d_with_index(x, kernel_size, stride=None, padding=0, global_pooling=False, adaptive=False):
    return _OPS['max_pool2d_with_index'](x, kernel_size, stride=stride, padding=padding, global_pooling=global_pooling, adaptive=adaptive)


def max_pool3d_with_index(x, kernel_size, stride=None, padding=0, global_pooling=False, adaptive=False):
    return _OPS['max_pool3d_with_index'](x, kernel_size, stride=stride, padding=padding, global_pooling=global_pooling, adaptive=adaptive)


def maximum(x, y):
    return _OPS['maximum'](x, y)


def maxout(x, groups, axis=1):
    return _OPS['maxout'](x, groups, axis=axis)


def maxpool(x, kernel_size, strides=None, paddings=0, ceil_mode=False, data_format='NCHW'):
    return _OPS['maxpool'](x, kernel_size, strides=strides, paddings=paddings, ceil_mode=ceil_mode, data_format=data_format)


def mean(x, axis=None, keepdim=False):
    return _OPS['mean'](x, axis=axis, keepdim=keepdim)


def mean_all(x):
    return _OPS['mean_all'](x)


def median(x, axis=None, keepdim=False):
    return _OPS['median'](x, axis=axis, keepdim=keepdim)


def memcpy_d2h(x, dst_place_type=0):
    raise _waiting_error('memcpy_d2h')  # item 7


def memcpy_h2d(x, dst_place_type=1):
    raise _waiting_error('memcpy_h2d')  # item 7


def memory_efficient_attention(query, key, value, bias=None, cu_seqlens_q=None, cu_seqlens_k=None, causal=False, dropout_p=0.0, scale=None):
    return _OPS['memory_efficient_attention'](query, key, value, bias=bias, cu_seqlens_q=cu_seqlens_q, cu_seqlens_k=cu_seqlens_k, causal=causal, dropout_p=dropout_p, scale=scale)


def merge_selected_rows(ids, values):
    return _OPS['merge_selected_rows'](ids, values)


def merged_adam_(params, grads, learning_rate, moments1, moments2, beta1_pows, beta2_pows, beta1=0.9, beta2=0.999, epsilon=1e-08):
    return _OPS['merged_adam_'](params, grads, learning_rate, moments1, moments2, beta1_pows, beta2_pows, beta1=beta1, beta2=beta2, epsilon=epsilon)


def merged_momentum_(params, grads, velocitys, learning_rate, mu=0.9, use_nesterov=False):
    return _OPS['merged_momentum_'](params, grads, velocitys, learning_rate, mu=mu, use_nesterov=use_nesterov)


def meshgrid(*xs):
    return _OPS['meshgrid'](*xs)


def min(x, axis=None, keepdim=False):
    return _OPS['min'](x, axis=axis, keepdim=keepdim)


def minimum(x, y):
    return _OPS['minimum'](x, y)


def mish(x):
    return _OPS['mish'](x)


def mm(x, y):
    return _OPS['mm'](x, y)


def mode(x, axis=-1, keepdim=False):
    return _OPS['mode'](x, axis=axis, keepdim=keepdim)


def momentum_(param, grad, velocity, learning_rate, mu=0.9, use_nesterov=False):
    return _OPS['momentum_'](param, grad, velocity, learning_rate, mu=mu, use_nesterov=use_nesterov)


def moveaxis(x, source, destination):
    return _OPS['moveaxis'](x, source, destination)


def mp_allreduce_sum(x, ring_id=0):
    raise _waiting_error('mp_allreduce_sum')  # item 7


def multi_dot(xs):
    return _OPS['multi_dot'](xs)


def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_top_k=1000, keep_top_k=100, nms_threshold=0.3, normalized=True, nms_eta=1.0, background_label=0):
    return _OPS['multiclass_nms'](bboxes, scores, score_threshold=score_threshold, nms_top_k=nms_top_k, keep_top_k=keep_top_k, nms_threshold=nms_threshold, normalized=normalized, nms_eta=nms_eta, background_label=background_label)


def multiclass_nms3(bboxes, scores, rois_num=None, score_threshold=0.05, nms_top_k=1000, keep_top_k=100, nms_threshold=0.3, normalized=True, nms_eta=1.0, background_label=-1):
    return _OPS['multiclass_nms3'](bboxes, scores, rois_num=rois_num, score_threshold=score_threshold, nms_top_k=nms_top_k, keep_top_k=keep_top_k, nms_threshold=nms_threshold, normalized=normalized, nms_eta=nms_eta, background_label=background_label)


def multihead_matmul(input, w, bias=None, bias_qk=None, transpose_qkv=False, alpha=1.0, head_number=1):
    return _OPS['multihead_matmul'](input, w, bias=bias, bias_qk=bias_qk, transpose_qkv=transpose_qkv, alpha=alpha, head_number=head_number)


def multinomial(x, num_samples=1, replacement=False, seed=0):
    return _OPS['multinomial'](x, num_samples=num_samples, replacement=replacement, seed=seed)


def multiplex(inputs, index):
    return _OPS['multiplex'](inputs, index)


def multiply(x, y):
    return _OPS['multiply'](x, y)


def multiply_add(x, y, z):
    return _OPS['multiply_add'](x, y, z)


def mv(x, vec):
    return _OPS['mv'](x, vec)


def nadam_(param, grad, learning_rate, moment1, moment2, beta1_pow, beta2_pow, beta1=0.9, beta2=0.999, epsilon=1e-08):
    return _OPS['nadam_'](param, grad, learning_rate, moment1, moment2, beta1_pow, beta2_pow, beta1=beta1, beta2=beta2, epsilon=epsilon)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return _OPS['nan_to_num'](x, nan=nan, posinf=posinf, neginf=neginf)


def nanmean(x, axis=None, keepdim=False):
    return _OPS['nanmean'](x, axis=axis, keepdim=keepdim)


def nanmedian(x, axis=None, keepdim=False):
    return _OPS['nanmedian'](x, axis=axis, keepdim=keepdim)


def nansum(x, axis=None, dtype=None, keepdim=False):
    return _OPS['nansum'](x, axis=axis, dtype=dtype, keepdim=keepdim)


def nce(input, label, weight, bias=None, sample_weight=None, custom_dist_probs=None, custom_dist_alias=None, custom_dist_alias_probs=None, num_total_classes=None, custom_neg_classes=(), num_neg_samples=10, sampler=0, seed=0, is_sparse=False, remote_prefetch=False, is_test=False):
    return _OPS['nce'](input, label, weight, bias=bias, sample_weight=sample_weight, custom_dist_probs=custom_dist_probs, custom_dist_alias=custom_dist_alias, custom_dist_alias_probs=custom_dist_alias_probs, num_total_classes=num_total_classes, custom_neg_classes=custom_neg_classes, num_neg_samples=num_neg_samples, sampler=sampler, seed=seed, is_sparse=is_sparse, remote_prefetch=remote_prefetch, is_test=is_test)


def nearest_interp(x, out_h, out_w, align_corners=False):
    return _OPS['nearest_interp'](x, out_h, out_w, align_corners=align_corners)


def nextafter(x, y):
    return _OPS['nextafter'](x, y)


def nll_loss(logp, label, weight=None, ignore_index=-100, reduction='mean'):
    return _OPS['nll_loss'](logp, label, weight=weight, ignore_index=ignore_index, reduction=reduction)


def nms(boxes, scores=None, iou_threshold=0.3, top_k=-1):
    return _OPS['nms'](boxes, scores=scores, iou_threshold=iou_threshold, top_k=top_k)


def nonzero(x, as_tuple=False):
    return _OPS['nonzero'](x, as_tuple=as_tuple)


def norm(x, p='fro', axis=None, keepdim=False):
    return _OPS['norm'](x, p=p, axis=axis, keepdim=keepdim)


def normal_like(x, mean=0.0, std=1.0, seed=0):
    return _OPS['normal_like'](x, mean=mean, std=std, seed=seed)


def not_equal(x, y):
    return _OPS['not_equal'](x, y)


def npu_identity(x, format=-1):
    raise _waiting_error('npu_identity')  # item 7


def number_count(numbers, upper_range):
    return _OPS['number_count'](numbers, upper_range)


def numel(x):
    return _OPS['numel'](x)


def one_hot(x, num_classes):
    return _OPS['one_hot'](x, num_classes)


def ones(shape, dtype=None):
    return _OPS['ones'](shape, dtype=dtype)


def ones_like(x, dtype=None):
    return _OPS['ones_like'](x, dtype=dtype)


def outer(x, y):
    return _OPS['outer'](x, y)


def overlap_add(x, hop_length, axis=-1):
    return _OPS['overlap_add'](x, hop_length, axis=axis)


def p_norm(x, porder=2.0, axis=-1, keepdim=False, epsilon=1e-12):
    return _OPS['p_norm'](x, porder=porder, axis=axis, keepdim=keepdim, epsilon=epsilon)


def p_recv(ring_id=0, peer=0, dtype='float32', dynamic_shape=False, out_shape=None):
    raise _waiting_error('p_recv')  # item 7


def p_recv_array(ring_id=0, peer=0, dtype='float32', out_shape=()):
    raise _waiting_error('p_recv_array')  # item 7


def p_send(x, ring_id=0, peer=0, dynamic_shape=False):
    raise _waiting_error('p_send')  # item 7


def p_send_array(x, ring_id=0, peer=0):
    raise _waiting_error('p_send_array')  # item 7


def pad(x, pad, mode='constant', value=0.0, data_format='NCHW'):
    return _OPS['pad'](x, pad, mode=mode, value=value, data_format=data_format)


def pad3d(x, paddings, mode='constant', value=0.0, data_format='NCDHW'):
    return _OPS['pad3d'](x, paddings, mode=mode, value=value, data_format=data_format)


def partial_allgather(x, nranks=1, rank=0, ring_id=0):
    raise _waiting_error('partial_allgather')  # item 7


def partial_concat(inputs, start_index=0, length=-1):
    return _OPS['partial_concat'](inputs, start_index=start_index, length=length)


def partial_sum(inputs, start_index=0, length=-1):
    return _OPS['partial_sum'](inputs, start_index=start_index, length=length)


def pinv(x, rcond=1e-15, hermitian=False):
    return _OPS['pinv'](x, rcond=rcond, hermitian=hermitian)


def pixel_shuffle(x, upscale_factor, data_format='NCHW'):
    return _OPS['pixel_shuffle'](x, upscale_factor, data_format=data_format)


def pixel_unshuffle(x, downscale_factor=1, data_format='NCHW'):
    return _OPS['pixel_unshuffle'](x, downscale_factor=downscale_factor, data_format=data_format)


def poisson(x, seed=0):
    return _OPS['poisson'](x, seed=seed)


def polygamma(x, n=1):
    return _OPS['polygamma'](x, n=n)


def pool2d(x, kernel_size, strides=None, paddings=0, ceil_mode=False, exclusive=True, data_format='NCHW', pooling_type='max', global_pooling=False, adaptive=False, padding_algorithm='EXPLICIT'):
    return _OPS['pool2d'](x, kernel_size, strides=strides, paddings=paddings, ceil_mode=ceil_mode, exclusive=exclusive, data_format=data_format, pooling_type=pooling_type, global_pooling=global_pooling, adaptive=adaptive, padding_algorithm=padding_algorithm)


def pool3d(x, kernel_size, stride=None, padding=0, pooling_type='max', ceil_mode=False, count_include_pad=True):
    return _OPS['pool3d'](x, kernel_size, stride=stride, padding=padding, pooling_type=pooling_type, ceil_mode=ceil_mode, count_include_pad=count_include_pad)


def pow(x, y):
    return _OPS['pow'](x, y)


def prelu(x, weight):
    return _OPS['prelu'](x, weight)


def prior_box(input, image, min_sizes=(), max_sizes=(), aspect_ratios=(1.0,), variances=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False, steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False):
    return _OPS['prior_box'](input, image, min_sizes=min_sizes, max_sizes=max_sizes, aspect_ratios=aspect_ratios, variances=variances, flip=flip, clip=clip, steps=steps, offset=offset, min_max_aspect_ratios_order=min_max_aspect_ratios_order)


def prod(x, axis=None, keepdim=False, dtype=None):
    return _OPS['prod'](x, axis=axis, keepdim=keepdim, dtype=dtype)


def prune_gate_by_capacity(gate_idx, expert_count, n_expert, n_worker=1):
    return _OPS['prune_gate_by_capacity'](gate_idx, expert_count, n_expert, n_worker=n_worker)


def psroi_pool(x, boxes, boxes_num=None, output_channels=1, spatial_scale=1.0, pooled_height=1, pooled_width=1):
    return _OPS['psroi_pool'](x, boxes, boxes_num=boxes_num, output_channels=output_channels, spatial_scale=spatial_scale, pooled_height=pooled_height, pooled_width=pooled_width)


def put_along_axis(x, indices, values, axis, reduce='assign'):
    return _OPS['put_along_axis'](x, indices, values, axis, reduce=reduce)


def pyramid_hash(x, w, white_list, black_list, lod, num_emb=8, space_len=100, pyramid_layer=2, rand_len=4, drop_out_percent=0.0, is_training=0, use_filter=False, white_list_len=0, black_list_len=0, seed=0, lr=1.0, distribute_update_vars=''):
    return _OPS['pyramid_hash'](x, w, white_list, black_list, lod, num_emb=num_emb, space_len=space_len, pyramid_layer=pyramid_layer, rand_len=rand_len, drop_out_percent=drop_out_percent, is_training=is_training, use_filter=use_filter, white_list_len=white_list_len, black_list_len=black_list_len, seed=seed, lr=lr, distribute_update_vars=distribute_update_vars)


def qkv_unpack_mha(q, k, v, src_mask):
    return _OPS['qkv_unpack_mha'](q, k, v, src_mask)


def qr(x, mode='reduced'):
    return _OPS['qr'](x, mode=mode)


def quant_linear(x, w, bias=None, in_num_col_dims=1, activation_type='', padding_weights=False, scale_in=1.0, scale_weights=(1.0,), quant_round_type=1, quant_max_bound=127.0, quant_min_bound=-127.0):
    return _OPS['quant_linear'](x, w, bias=bias, in_num_col_dims=in_num_col_dims, activation_type=activation_type, padding_weights=padding_weights, scale_in=scale_in, scale_weights=scale_weights, quant_round_type=quant_round_type, quant_max_bound=quant_max_bound, quant_min_bound=quant_min_bound)


def quantile(x, q, axis=None, keepdim=False):
    return _OPS['quantile'](x, q, axis=axis, keepdim=keepdim)


def quantize_linear(x, scale, zero_point=None, in_accum=None, in_state=None, quant_axis=0, bit_length=8, qmin=-128, qmax=127, round_type=0, is_test=True, only_observer=False):
    return _OPS['quantize_linear'](x, scale, zero_point=zero_point, in_accum=in_accum, in_state=in_state, quant_axis=quant_axis, bit_length=bit_length, qmin=qmin, qmax=qmax, round_type=round_type, is_test=is_test, only_observer=only_observer)


def rad2deg(x):
    return _OPS['rad2deg'](x)


def radam_(param, grad, learning_rate, moment1, moment2, beta1_pow, beta2_pow, rho=None, beta1=0.9, beta2=0.999, epsilon=1e-08):
    return _OPS['radam_'](param, grad, learning_rate, moment1, moment2, beta1_pow, beta2_pow, rho=rho, beta1=beta1, beta2=beta2, epsilon=epsilon)


def randint(low=0, high=None, shape=(1,), dtype=None, seed=0):
    return _OPS['randint'](low=low, high=high, shape=shape, dtype=dtype, seed=seed)


def random_routing(topk_idx, topk_value, prob):
    return _OPS['random_routing'](topk_idx, topk_value, prob)


def randperm(n, dtype=None, seed=0):
    return _OPS['randperm'](n, dtype=dtype, seed=seed)


def rank_attention(x, rank_offset, rank_param, max_rank=3, max_size=0):
    return _OPS['rank_attention'](x, rank_offset, rank_param, max_rank=max_rank, max_size=max_size)


def read_file(filename):
    return _OPS['read_file'](filename)


def real(x):
    return _OPS['real'](x)


def reciprocal(x):
    return _OPS['reciprocal'](x)


def reduce(x, root_id=0, reduce_type=0, ring_id=0):
    raise _waiting_error('reduce')  # item 7


def reduce_as(x, target):
    return _OPS['reduce_as'](x, target)


def reduce_scatter(x, ring_id=0, nranks=1):
    raise _waiting_error('reduce_scatter')  # item 7


def reindex_graph(x, neighbors, count, hashtable_value=None, hashtable_index=None):
    return _OPS['reindex_graph'](x, neighbors, count, hashtable_value=hashtable_value, hashtable_index=hashtable_index)


def relu(x):
    return _OPS['relu'](x)


def relu6(x):
    return _OPS['relu6'](x)


def remainder(x, y):
    return _OPS['remainder'](x, y)


def renorm(x, p, axis, max_norm):
    return _OPS['renorm'](x, p, axis, max_norm)


def repeat_interleave(x, repeats, axis=None):
    return _OPS['repeat_interleave'](x, repeats, axis=axis)


def repeat_interleave_with_tensor_index(x, repeats, axis=0):
    return _OPS['repeat_interleave_with_tensor_index'](x, repeats, axis=axis)


def reshape(x, shape):
    return _OPS['reshape'](x, shape)


def resnet_basic_block(x, filter1, scale1, bias1, mean1, var1, filter2, scale2, bias2, mean2, var2, filter3=None, scale3=None, bias3=None, mean3=None, var3=None, stride1=1, stride2=1, stride3=1, padding1=1, padding2=1, padding3=0, has_shortcut=False, epsilon=1e-05, act_type='relu'):
    return _OPS['resnet_basic_block'](x, filter1, scale1, bias1, mean1, var1, filter2, scale2, bias2, mean2, var2, filter3=filter3, scale3=scale3, bias3=bias3, mean3=mean3, var3=var3, stride1=stride1, stride2=stride2, stride3=stride3, padding1=padding1, padding2=padding2, padding3=padding3, has_shortcut=has_shortcut, epsilon=epsilon, act_type=act_type)


def resnet_unit(x, filter_x, scale_x, bias_x, mean_x, var_x, z=None, filter_z=None, scale_z=None, bias_z=None, mean_z=None, var_z=None, stride=1, padding=1, dilation=1, group=1, momentum=0.9, epsilon=1e-05, fuse_add=False, has_shortcut=False, act_type='relu'):
    return _OPS['resnet_unit'](x, filter_x, scale_x, bias_x, mean_x, var_x, z=z, filter_z=filter_z, scale_z=scale_z, bias_z=bias_z, mean_z=mean_z, var_z=var_z, stride=stride, padding=padding, dilation=dilation, group=group, momentum=momentum, epsilon=epsilon, fuse_add=fuse_add, has_shortcut=has_shortcut, act_type=act_type)


def reverse(x, axis):
    return _OPS['reverse'](x, axis)


def rms_norm(x, weight=None, bias=None, epsilon=1e-06):
    return _OPS['rms_norm'](x, weight=weight, bias=bias, epsilon=epsilon)


def rmsprop_(param, mean_square, grad, moment, learning_rate, epsilon=1e-10, decay=0.9, momentum=0.0, centered=False, mean_grad=None):
    return _OPS['rmsprop_'](param, mean_square, grad, moment, learning_rate, epsilon=epsilon, decay=decay, momentum=momentum, centered=centered, mean_grad=mean_grad)


def rnn(x, initial_h, initial_c, weight_list, seq_lens=None, dropout_mask=None, mode='LSTM', num_layers=1, is_bidirec=False, time_major=False, activation='tanh'):
    return _OPS['rnn'](x, initial_h, initial_c, weight_list, seq_lens=seq_lens, dropout_mask=dropout_mask, mode=mode, num_layers=num_layers, is_bidirec=is_bidirec, time_major=time_major, activation=activation)


def roi_align(x, boxes, boxes_num=None, pooled_height=1, pooled_width=1, spatial_scale=1.0, sampling_ratio=-1, aligned=True):
    return _OPS['roi_align'](x, boxes, boxes_num=boxes_num, pooled_height=pooled_height, pooled_width=pooled_width, spatial_scale=spatial_scale, sampling_ratio=sampling_ratio, aligned=aligned)


def roi_pool(x, boxes, boxes_num=None, pooled_height=1, pooled_width=1, spatial_scale=1.0):
    return _OPS['roi_pool'](x, boxes, boxes_num=boxes_num, pooled_height=pooled_height, pooled_width=pooled_width, spatial_scale=spatial_scale)


def roll(x, shifts, axis=None):
    return _OPS['roll'](x, shifts, axis=axis)


def rot90(x, k=1, axes=(0, 1)):
    return _OPS['rot90'](x, k=k, axes=axes)


def round(x, decimals=0):
    return _OPS['round'](x, decimals=decimals)


def row_conv(x, filter, lod=None):
    return _OPS['row_conv'](x, filter, lod=lod)


def rprop_(param, grad, prev, learning_rate, learning_rate_range, etas):
    return _OPS['rprop_'](param, grad, prev, learning_rate, learning_rate_range, etas)


def rrelu(x, lower=0.125, upper=0.3333333333333333, is_test=False):
    return _OPS['rrelu'](x, lower=lower, upper=upper, is_test=is_test)


def rsqrt(x):
    return _OPS['rsqrt'](x)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    return _OPS['scale'](x, scale=scale, bias=bias, bias_after_scale=bias_after_scale)


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0, is_causal=False, training=True, scale=None):
    return _OPS['scaled_dot_product_attention'](q, k, v, attn_mask=attn_mask, dropout_p=dropout_p, is_causal=is_causal, training=training, scale=scale)


def scatter(x, index, updates, overwrite=True):
    return _OPS['scatter'](x, index, updates, overwrite=overwrite)


def scatter_nd_add(x, index, updates):
    return _OPS['scatter_nd_add'](x, index, updates)


def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    return _OPS['searchsorted'](sorted_sequence, values, out_int32=out_int32, right=right)


def segment_max(data, segment_ids):
    raise _waiting_error('segment_max')  # item 9


def segment_mean(data, segment_ids):
    raise _waiting_error('segment_mean')  # item 9


def segment_min(data, segment_ids):
    raise _waiting_error('segment_min')  # item 9


def segment_pool(x, segment_ids, pooltype='SUM', num_segments=None):
    return _OPS['segment_pool'](x, segment_ids, pooltype=pooltype, num_segments=num_segments)


def segment_sum(data, segment_ids):
    raise _waiting_error('segment_sum')  # item 9


def self_dp_attention(x, alpha=1.0, head_number=1):
    return _OPS['self_dp_attention'](x, alpha=alpha, head_number=head_number)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return _OPS['selu'](x, scale=scale, alpha=alpha)


def send_u_recv(x, src_index, dst_index, reduce_op='SUM', out_size=None):
    return _OPS['send_u_recv'](x, src_index, dst_index, reduce_op=reduce_op, out_size=out_size)


def send_ue_recv(x, y, src_index, dst_index, message_op='ADD', reduce_op='SUM', out_size=None):
    return _OPS['send_ue_recv'](x, y, src_index, dst_index, message_op=message_op, reduce_op=reduce_op, out_size=out_size)


def send_uv(x, y, src_index, dst_index, message_op='ADD'):
    return _OPS['send_uv'](x, y, src_index, dst_index, message_op=message_op)


def sequence_conv(x, filter, lod, context_length=3, context_start=None, context_stride=1, padding_data=None):
    return _OPS['sequence_conv'](x, filter, lod, context_length=context_length, context_start=context_start, context_stride=context_stride, padding_data=padding_data)


def sequence_expand(x, y_lod, ref_level=0, x_lod=None):
    return _OPS['sequence_expand'](x, y_lod, ref_level=ref_level, x_lod=x_lod)


def sequence_mask(x, maxlen=None, out_dtype='int64'):
    return _OPS['sequence_mask'](x, maxlen=maxlen, out_dtype=out_dtype)


def sequence_pad(x, pad_value, lod, padded_length=None):
    return _OPS['sequence_pad'](x, pad_value, lod, padded_length=padded_length)


def sequence_pool(x, lengths, pool_type='SUM'):
    return _OPS['sequence_pool'](x, lengths, pool_type=pool_type)


def sequence_softmax(x, lod):
    return _OPS['sequence_softmax'](x, lod)


def sequence_unpad(x, length):
    return _OPS['sequence_unpad'](x, length)


def set(x, source):
    raise _waiting_error('set')  # item 7


def set_value_with_tensor(x, values, starts, ends, steps, axes, decrease_axes=(), none_axes=()):
    raise _waiting_error('set_value_with_tensor')  # item 7


def setitem(x, value, idx):
    return _OPS['setitem'](x, value, idx)


def sgd_(param, learning_rate, grad):
    return _OPS['sgd_'](param, learning_rate, grad)


def shadow_output(x, name=''):
    return _OPS['shadow_output'](x, name=name)


def shape(input):
    raise _waiting_error('shape')  # item 7


def shard_index(x, index_num, nshards, shard_id, ignore_value=-1):
    return _OPS['shard_index'](x, index_num, nshards, shard_id, ignore_value=ignore_value)


def share_buffer(x, share_dims_and_dtype=()):
    return _OPS['share_buffer'](x, share_dims_and_dtype=share_dims_and_dtype)


def share_data(x):
    raise _waiting_error('share_data')  # item 7


def shuffle_batch(x, seed=0):
    return _OPS['shuffle_batch'](x, seed=seed)


def shuffle_channel(x, group=1):
    return _OPS['shuffle_channel'](x, group=group)


def sigmoid(x):
    return _OPS['sigmoid'](x)


def sigmoid_cross_entropy_with_logits(x, label, normalize=False, ignore_index=-100):
    return _OPS['sigmoid_cross_entropy_with_logits'](x, label, normalize=normalize, ignore_index=ignore_index)


def sign(x):
    return _OPS['sign'](x)


def silu(x):
    return _OPS['silu'](x)


def sin(x):
    return _OPS['sin'](x)


def sinh(x):
    return _OPS['sinh'](x)


def skip_layernorm(x, y, scale, bias, epsilon=1e-05, begin_norm_axis=-1):
    return _OPS['skip_layernorm'](x, y, scale, bias, epsilon=epsilon, begin_norm_axis=begin_norm_axis)


def slice(input, axes, starts, ends, infer_flags=(), decrease_axis=()):
    raise _waiting_error('slice')  # item 7


def slogdet(x):
    return _OPS['slogdet'](x)


def softmax(x, axis=-1):
    return _OPS['softmax'](x, axis=axis)


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100, axis=-1):
    return _OPS['softmax_with_cross_entropy'](logits, label, soft_label=soft_label, ignore_index=ignore_index, axis=axis)


def softplus(x, beta=1.0, threshold=20.0):
    return _OPS['softplus'](x, beta=beta, threshold=threshold)


def softshrink(x, threshold=0.5):
    return _OPS['softshrink'](x, threshold=threshold)


def softsign(x):
    return _OPS['softsign'](x)


def solve(x, y):
    return _OPS['solve'](x, y)


def sort(x, axis=-1, descending=False, stable=False):
    return _OPS['sort'](x, axis=axis, descending=descending, stable=stable)


def sparse_attention(q, k, v, offset, columns, key_padding_mask=None, attn_mask=None):
    return _OPS['sparse_attention'](q, k, v, offset, columns, key_padding_mask=key_padding_mask, attn_mask=attn_mask)


def sparse_coo_tensor(values, indices, shape=()):
    raise _waiting_error('sparse_coo_tensor')  # item 9


def sparse_momentum(param, grad, velocity, index, learning_rate, mu=0.9, use_nesterov=False, regularization_method='', regularization_coeff=0.0, axis=0):
    return _OPS['sparse_momentum'](param, grad, velocity, index, learning_rate, mu=mu, use_nesterov=use_nesterov, regularization_method=regularization_method, regularization_coeff=regularization_coeff, axis=axis)


def spectral_norm(weight, u, v, dim=0, power_iters=1, eps=1e-12):
    return _OPS['spectral_norm'](weight, u, v, dim=dim, power_iters=power_iters, eps=eps)


def split(x, num_or_sections, axis=0):
    return _OPS['split'](x, num_or_sections, axis=axis)


def split_with_num(x, num, axis=0):
    return _OPS['split_with_num'](x, num, axis=axis)


def sqrt(x):
    return _OPS['sqrt'](x)


def square(x):
    return _OPS['square'](x)


def squared_l2_norm(x):
    return _OPS['squared_l2_norm'](x)


def squeeze(x, axis=None):
    return _OPS['squeeze'](x, axis=axis)


def squeeze_excitation_block(x, filter_squeeze, filter_excitation, act_type=('relu', 'sigmoid')):
    return _OPS['squeeze_excitation_block'](x, filter_squeeze, filter_excitation, act_type=act_type)


def stack(xs, axis=0):
    return _OPS['stack'](xs, axis=axis)


def standard_gamma(x, seed=0):
    return _OPS['standard_gamma'](x, seed=seed)


def stanh(x, scale_a=0.67, scale_b=1.7159):
    return _OPS['stanh'](x, scale_a=scale_a, scale_b=scale_b)


def std(x, axis=None, unbiased=True, keepdim=False):
    return _OPS['std'](x, axis=axis, unbiased=unbiased, keepdim=keepdim)


def stft(x, window, n_fft, hop_length, normalized=False, onesided=True):
    return _OPS['stft'](x, window, n_fft, hop_length, normalized=normalized, onesided=onesided)


def strided_slice(x, axes, starts, ends, strides):
    return _OPS['strided_slice'](x, axes, starts, ends, strides)


def subtract(x, y):
    return _OPS['subtract'](x, y)


def sum(x, axis=None, dtype=None, keepdim=False):
    return _OPS['sum'](x, axis=axis, dtype=dtype, keepdim=keepdim)


def svd(x, full_matrices=False):
    return _OPS['svd'](x, full_matrices=full_matrices)


def swapaxes(x, axis0, axis1):
    return _OPS['swapaxes'](x, axis0, axis1)


def swiglu(x, y=None):
    return _OPS['swiglu'](x, y=y)


def swish(x):
    return _OPS['swish'](x)


def sync_batch_norm_(x, mean, variance, scale, bias, is_test=False, momentum=0.9, epsilon=1e-05, data_format='NCHW', use_global_stats=False, trainable_statistics=False):
    return _OPS['sync_batch_norm_'](x, mean, variance, scale, bias, is_test=is_test, momentum=momentum, epsilon=epsilon, data_format=data_format, use_global_stats=use_global_stats, trainable_statistics=trainable_statistics)


def sync_calc_stream(x):
    raise _waiting_error('sync_calc_stream')  # item 7


def take_along_axis(x, indices, axis, broadcast=True):
    return _OPS['take_along_axis'](x, indices, axis, broadcast=broadcast)


def tan(x):
    return _OPS['tan'](x)


def tanh(x):
    return _OPS['tanh'](x)


def tanh_shrink(x):
    return _OPS['tanh_shrink'](x)


def tanhshrink(x):
    return _OPS['tanhshrink'](x)


def tdm_child(x, tree_info, child_nums=2):
    return _OPS['tdm_child'](x, tree_info, child_nums=child_nums)


def tdm_sampler(x, travel, layer, neg_samples_num_list=(1,), layer_offset_lod=(0, 1), output_positive=True, seed=0):
    return _OPS['tdm_sampler'](x, travel, layer, neg_samples_num_list=neg_samples_num_list, layer_offset_lod=layer_offset_lod, output_positive=output_positive, seed=seed)


def temporal_shift(x, seg_num=1, shift_ratio=0.25, data_format='NCHW'):
    return _OPS['temporal_shift'](x, seg_num=seg_num, shift_ratio=shift_ratio, data_format=data_format)


def thresholded_relu(x, threshold=1.0, value=0.0):
    return _OPS['thresholded_relu'](x, threshold=threshold, value=value)


def tile(x, repeat_times):
    return _OPS['tile'](x, repeat_times)


def to_dense(x):
    raise _waiting_error('to_dense')  # item 9


def to_sparse_coo(x, sparse_dim=None):
    raise _waiting_error('to_sparse_coo')  # item 9


def to_sparse_csr(x):
    raise _waiting_error('to_sparse_csr')  # item 9


def top_p_sampling(x, ps, threshold=None, seed=0):
    return _OPS['top_p_sampling'](x, ps, threshold=threshold, seed=seed)


def topk(x, k, axis=-1, largest=True, sorted=True):
    return _OPS['topk'](x, k, axis=axis, largest=largest, sorted=sorted)


def topk_v1(x, k=1):
    return _OPS['topk_v1'](x, k=k)


def trace(x, offset=0, axis1=0, axis2=1):
    return _OPS['trace'](x, offset=offset, axis1=axis1, axis2=axis2)


def trans_layout(x, perm):
    raise _waiting_error('trans_layout')  # item 7


def transfer_layout(x, src_layout=-1, dst_layout=-1):
    return _OPS['transfer_layout'](x, src_layout=src_layout, dst_layout=dst_layout)


def transpose(x, perm):
    return _OPS['transpose'](x, perm)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    return _OPS['triangular_solve'](x, y, upper=upper, transpose=transpose, unitriangular=unitriangular)


def tril(x, diagonal=0):
    return _OPS['tril'](x, diagonal=diagonal)


def tril_indices(row, col, offset=0):
    return _OPS['tril_indices'](row, col, offset=offset)


def tril_triu(x, diagonal=0, lower=True):
    return _OPS['tril_triu'](x, diagonal=diagonal, lower=lower)


def trilinear_interp(x, out_d, out_h, out_w, align_corners=True, align_mode=1):
    return _OPS['trilinear_interp'](x, out_d, out_h, out_w, align_corners=align_corners, align_mode=align_mode)


def triu(x, diagonal=0):
    return _OPS['triu'](x, diagonal=diagonal)


def triu_indices(row, col, offset=0):
    return _OPS['triu_indices'](row, col, offset=offset)


def trunc(x):
    return _OPS['trunc'](x)


def truncated_gaussian_random(shape, mean=0.0, std=1.0, seed=0, a=-2.0, b=2.0, dtype='float32'):
    return _OPS['truncated_gaussian_random'](shape, mean=mean, std=std, seed=seed, a=a, b=b, dtype=dtype)


def unbind(x, axis=0):
    return _OPS['unbind'](x, axis=axis)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    return _OPS['unfold'](x, kernel_sizes, strides=strides, paddings=paddings, dilations=dilations)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0):
    return _OPS['uniform'](shape, dtype=dtype, min=min, max=max, seed=seed)


def uniform_inplace(x, min=-1.0, max=1.0, seed=0, diag_num=0, diag_step=0, diag_val=1.0):
    return _OPS['uniform_inplace'](x, min=min, max=max, seed=seed, diag_num=diag_num, diag_step=diag_step, diag_val=diag_val)


def uniform_random_batch_size_like(input, shape, min=-1.0, max=1.0, input_dim_idx=0, output_dim_idx=0, seed=0, dtype='float32'):
    return _OPS['uniform_random_batch_size_like'](input, shape, min=min, max=max, input_dim_idx=input_dim_idx, output_dim_idx=output_dim_idx, seed=seed, dtype=dtype)


def uniform_random_like(x, min=-1.0, max=1.0, seed=0):
    return _OPS['uniform_random_like'](x, min=min, max=max, seed=seed)


def unique(x, return_index=False, return_inverse=False, return_counts=False, axis=None):
    return _OPS['unique'](x, return_index=return_index, return_inverse=return_inverse, return_counts=return_counts, axis=axis)


def unique_consecutive(x, return_inverse=False, return_counts=False, axis=None, dtype='int64'):
    return _OPS['unique_consecutive'](x, return_inverse=return_inverse, return_counts=return_counts, axis=axis, dtype=dtype)


def unpool(x, indices, kernel_size=2, stride=None, padding=0, output_size=None, data_format='NCHW'):
    return _OPS['unpool'](x, indices, kernel_size=kernel_size, stride=stride, padding=padding, output_size=output_size, data_format=data_format)


def unpool3d(x, indices, kernel_size=2, stride=None, padding=0, output_size=None, data_format='NCDHW'):
    return _OPS['unpool3d'](x, indices, kernel_size=kernel_size, stride=stride, padding=padding, output_size=output_size, data_format=data_format)


def unsqueeze(x, axis):
    return _OPS['unsqueeze'](x, axis)


def unstack(x, axis=0, num=None):
    return _OPS['unstack'](x, axis=axis, num=num)


def update_loss_scaling_(xs, found_infinite, prev_loss_scaling, in_good_steps, in_bad_steps, incr_every_n_steps=1000, decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5, stop_update=False):
    return _OPS['update_loss_scaling_'](xs, found_infinite, prev_loss_scaling, in_good_steps, in_bad_steps, incr_every_n_steps=incr_every_n_steps, decr_every_n_nan_or_inf=decr_every_n_nan_or_inf, incr_ratio=incr_ratio, decr_ratio=decr_ratio, stop_update=stop_update)


def upper(x, use_utf8_encoding=False):
    return _OPS['upper'](x, use_utf8_encoding=use_utf8_encoding)


def values(x):
    raise _waiting_error('values')  # item 9


def var(x, axis=None, unbiased=True, keepdim=False):
    return _OPS['var'](x, axis=axis, unbiased=unbiased, keepdim=keepdim)


def variable_length_memory_efficient_attention(query, key, value, seq_lens, kv_seq_lens, mask=None, scale=None, causal=False, pre_cache_length=0):
    return _OPS['variable_length_memory_efficient_attention'](query, key, value, seq_lens, kv_seq_lens, mask=mask, scale=scale, causal=causal, pre_cache_length=pre_cache_length)


def view_dtype(input, dtype):
    return _OPS['view_dtype'](input, dtype)


def view_shape(input, dims):
    return _OPS['view_shape'](input, dims)


def view_slice(input, begin_idx, end_idx):
    return _OPS['view_slice'](input, begin_idx, end_idx)


def viterbi_decode(potentials, transition_params, lengths, include_bos_eos_tag=True):
    return _OPS['viterbi_decode'](potentials, transition_params, lengths, include_bos_eos_tag=include_bos_eos_tag)


def warpctc(logits, label, logits_length, labels_length, blank=0, norm_by_times=False):
    return _OPS['warpctc'](logits, label, logits_length, labels_length, blank=blank, norm_by_times=norm_by_times)


def warprnnt(input, label, input_lengths, label_lengths, blank=0, fastemit_lambda=0.0):
    return _OPS['warprnnt'](input, label, input_lengths, label_lengths, blank=blank, fastemit_lambda=fastemit_lambda)


def weight_dequantize(x, scale, algo='weight_only_int8', out_dtype='float32'):
    return _OPS['weight_dequantize'](x, scale, algo=algo, out_dtype=out_dtype)


def weight_only_linear(x, weight, bias=None, weight_scale=None, weight_dtype='int8', arch=0, group_size=-1):
    return _OPS['weight_only_linear'](x, weight, bias=bias, weight_scale=weight_scale, weight_dtype=weight_dtype, arch=arch, group_size=group_size)


def weight_quantize(x, algo='weight_only_int8', arch=0, group_size=-1):
    return _OPS['weight_quantize'](x, algo=algo, arch=arch, group_size=group_size)


def weighted_sample_neighbors(row, colptr, edge_weight, x, eids=None, sample_size=-1, return_eids=False, seed=0):
    return _OPS['weighted_sample_neighbors'](row, colptr, edge_weight, x, eids=eids, sample_size=sample_size, return_eids=return_eids, seed=seed)


def where(condition, x, y):
    return _OPS['where'](condition, x, y)


def yolo_box(x, img_size, anchors=(), class_num=1, conf_thresh=0.01, downsample_ratio=32, clip_bbox=True, scale_x_y=1.0, iou_aware=False, iou_aware_factor=0.5):
    return _OPS['yolo_box'](x, img_size, anchors=anchors, class_num=class_num, conf_thresh=conf_thresh, downsample_ratio=downsample_ratio, clip_bbox=clip_bbox, scale_x_y=scale_x_y, iou_aware=iou_aware, iou_aware_factor=iou_aware_factor)


def yolo_box_head(x, anchors=(), class_num=1):
    return _OPS['yolo_box_head'](x, anchors=anchors, class_num=class_num)


def yolo_box_post(boxes0, boxes1, boxes2, image_shape, image_scale, anchors0=(), anchors1=(), anchors2=(), class_num=80, conf_thresh=0.01, downsample_ratio0=8, downsample_ratio1=16, downsample_ratio2=32, clip_bbox=True, scale_x_y=1.0, nms_threshold=0.45):
    return _OPS['yolo_box_post'](boxes0, boxes1, boxes2, image_shape, image_scale, anchors0=anchors0, anchors1=anchors1, anchors2=anchors2, class_num=class_num, conf_thresh=conf_thresh, downsample_ratio0=downsample_ratio0, downsample_ratio1=downsample_ratio1, downsample_ratio2=downsample_ratio2, clip_bbox=clip_bbox, scale_x_y=scale_x_y, nms_threshold=nms_threshold)


def yolo_loss(x, gt_box, gt_label, gt_score=None, anchors=(), anchor_mask=(), class_num=1, ignore_thresh=0.7, downsample_ratio=32, use_label_smooth=True, scale_x_y=1.0):
    return _OPS['yolo_loss'](x, gt_box, gt_label, gt_score=gt_score, anchors=anchors, anchor_mask=anchor_mask, class_num=class_num, ignore_thresh=ignore_thresh, downsample_ratio=downsample_ratio, use_label_smooth=use_label_smooth, scale_x_y=scale_x_y)


def zeros(shape, dtype=None):
    return _OPS['zeros'](shape, dtype=dtype)


def zeros_like(x, dtype=None):
    return _OPS['zeros_like'](x, dtype=dtype)



WAITING = [
    'all_gather',
    'all_reduce',
    'all_to_all',
    'assign_out_',
    'assign_value_',
    'barrier',
    'broadcast',
    'c_allgather',
    'c_allreduce_max',
    'c_allreduce_min',
    'c_allreduce_prod',
    'c_allreduce_sum',
    'c_broadcast',
    'c_concat',
    'c_identity',
    'c_reduce_sum',
    'c_scatter',
    'c_softmax_with_cross_entropy',
    'coalesce',
    'coalesce_tensor',
    'comm_init_all',
    'copy_to',
    'depend',
    'dist_concat',
    'fake_quantize_dequantize_abs_max',
    'fetch_barrier',
    'full_',
    'full_int_array',
    'full_with_tensor',
    'global_gather',
    'global_scatter',
    'graph_send_recv',
    'graph_send_ue_recv',
    'graph_send_uv',
    'indices',
    'mask_as',
    'masked_matmul',
    'memcpy_d2h',
    'memcpy_h2d',
    'mp_allreduce_sum',
    'npu_identity',
    'p_recv',
    'p_recv_array',
    'p_send',
    'p_send_array',
    'partial_allgather',
    'reduce',
    'reduce_scatter',
    'segment_max',
    'segment_mean',
    'segment_min',
    'segment_sum',
    'set',
    'set_value_with_tensor',
    'shape',
    'share_data',
    'slice',
    'sparse_coo_tensor',
    'sync_calc_stream',
    'to_dense',
    'to_sparse_coo',
    'to_sparse_csr',
    'trans_layout',
    'values',
]


__all__ = [
    'abs',
    'accuracy',
    'accuracy_check',
    'acos',
    'acosh',
    'adadelta_',
    'adagrad_',
    'adam_',
    'adamax_',
    'adamw_',
    'adaptive_avg_pool1d',
    'adaptive_avg_pool2d',
    'adaptive_avg_pool3d',
    'adaptive_max_pool1d',
    'adaptive_max_pool2d',
    'adaptive_max_pool3d',
    'add',
    'add_group_norm_silu',
    'add_n',
    'add_position_encoding',
    'addmm',
    'affine_channel',
    'affine_grid',
    'all',
    'all_gather',
    'all_reduce',
    'all_to_all',
    'allclose',
    'amax',
    'amin',
    'anchor_generator',
    'angle',
    'any',
    'apply_per_channel_scale',
    'arange',
    'argmax',
    'argmin',
    'argsort',
    'as_complex',
    'as_real',
    'as_strided',
    'asgd_',
    'asin',
    'asinh',
    'assign',
    'assign_out_',
    'assign_pos',
    'assign_value',
    'assign_value_',
    'atan',
    'atan2',
    'atanh',
    'attention_lstm',
    'auc',
    'average_accumulates_',
    'avg_pool1d',
    'avg_pool2d',
    'barrier',
    'batch_fc',
    'batch_norm',
    'batch_norm_',
    'batch_norm_infer',
    'batch_norm_train',
    'bce_loss',
    'bce_with_logits',
    'beam_search',
    'beam_search_decode',
    'bernoulli',
    'bicubic_interp',
    'bilinear',
    'bilinear_interp',
    'bincount',
    'binomial',
    'bipartite_match',
    'bitwise_and',
    'bitwise_left_shift',
    'bitwise_not',
    'bitwise_or',
    'bitwise_right_shift',
    'bitwise_xor',
    'blha_get_max_len',
    'block_multihead_attention_',
    'bmm',
    'box_clip',
    'box_coder',
    'broadcast',
    'broadcast_tensors',
    'broadcast_to',
    'c_allgather',
    'c_allreduce_max',
    'c_allreduce_min',
    'c_allreduce_prod',
    'c_allreduce_sum',
    'c_broadcast',
    'c_concat',
    'c_embedding',
    'c_identity',
    'c_reduce_sum',
    'c_scatter',
    'c_softmax_with_cross_entropy',
    'c_split',
    'calc_reduced_attn_scores',
    'cast',
    'ceil',
    'celu',
    'channel_shuffle',
    'check_finite_and_unscale_',
    'check_numerics',
    'cholesky',
    'cholesky_solve',
    'chunk',
    'chunk_eval',
    'class_center_sample',
    'clip',
    'clip_by_norm',
    'coalesce',
    'coalesce_tensor',
    'collect_fpn_proposals',
    'comm_init_all',
    'complex',
    'concat',
    'cond',
    'conj',
    'conv1d',
    'conv2d',
    'conv2d_transpose',
    'conv2d_transpose_bias',
    'conv3d',
    'conv3d_implicit_gemm',
    'conv3d_transpose',
    'copy_to',
    'copysign',
    'corrcoef',
    'correlation',
    'cos',
    'cosh',
    'count_nonzero',
    'cov',
    'crf_decoding',
    'crop',
    'cross',
    'cross_entropy',
    'cross_entropy2',
    'cross_entropy_with_softmax',
    'ctc_align',
    'ctc_loss',
    'cudnn_lstm',
    'cummax',
    'cummin',
    'cumprod',
    'cumsum',
    'cvm',
    'data',
    'decayed_adagrad',
    'decode_jpeg',
    'deformable_conv',
    'deg2rad',
    'depend',
    'depthwise_conv2d',
    'depthwise_conv2d_transpose',
    'dequantize_abs_max',
    'dequantize_linear',
    'dequantize_log',
    'det',
    'detection_map',
    'dgc',
    'dgc_clip_by_norm',
    'dgc_momentum',
    'diag',
    'diag_embed',
    'diagflat',
    'diagonal',
    'digamma',
    'dirichlet',
    'disable_check_model_nan_inf',
    'dist',
    'dist_concat',
    'distribute_fpn_proposals',
    'distributed_fused_lamb_init',
    'divide',
    'divide_scalar',
    'dot',
    'dpsgd',
    'dropout',
    'dropout_nd',
    'edit_distance',
    'eig',
    'eigh',
    'eigvals',
    'eigvalsh',
    'einsum',
    'elementwise_floordiv',
    'elementwise_max',
    'elementwise_min',
    'elementwise_mod',
    'elementwise_pow',
    'elementwise_rpow',
    'elu',
    'embedding',
    'empty',
    'empty_like',
    'enable_check_model_nan_inf',
    'equal',
    'equal_all',
    'erf',
    'erfinv',
    'exp',
    'expand',
    'expand_as',
    'expand_as_v2',
    'expm1',
    'exponential_',
    'eye',
    'fake_channel_wise_dequantize_max_abs',
    'fake_channel_wise_quantize_abs_max',
    'fake_channel_wise_quantize_dequantize_abs_max',
    'fake_dequantize_max_abs',
    'fake_quantize_abs_max',
    'fake_quantize_dequantize_abs_max',
    'fake_quantize_dequantize_moving_average_abs_max',
    'fake_quantize_moving_average_abs_max',
    'fake_quantize_range_abs_max',
    'fc',
    'fetch_barrier',
    'fft_c2c',
    'fft_c2r',
    'fft_r2c',
    'fill',
    'fill_diagonal',
    'fill_diagonal_tensor',
    'flash_attn',
    'flash_attn_qkvpacked',
    'flash_attn_unpadded',
    'flash_attn_varlen_qkvpacked',
    'flashmask_attention',
    'flatten',
    'flatten2',
    'flip',
    'floor',
    'floor_divide',
    'fmax',
    'fmin',
    'fold',
    'fp8_fp8_half_gemm_fused',
    'frac',
    'fractional_max_pool2d',
    'fractional_max_pool3d',
    'frame',
    'frobenius_norm',
    'ftrl',
    'ftrl_',
    'full',
    'full_',
    'full_batch_size_like',
    'full_int_array',
    'full_like',
    'full_with_tensor',
    'fused_attention',
    'fused_batch_norm_act',
    'fused_bias_act',
    'fused_bias_dropout_residual_layer_norm',
    'fused_bias_residual_layernorm',
    'fused_bn_add_activation',
    'fused_conv2d_add_act',
    'fused_dconv_drelu_dbn',
    'fused_dot_product_attention',
    'fused_dropout_add',
    'fused_elementwise_add',
    'fused_elementwise_div',
    'fused_elementwise_mul',
    'fused_elementwise_sub',
    'fused_elemwise_activation',
    'fused_elemwise_add_activation',
    'fused_embedding_eltwise_layernorm',
    'fused_embedding_fc_lstm',
    'fused_fc_elementwise_layernorm',
    'fused_feedforward',
    'fused_linear',
    'fused_linear_param_grad_add',
    'fused_moe',
    'fused_multi_transformer_',
    'fused_rms_norm',
    'fused_rotary_position_embedding',
    'fused_scale_bias_add_relu',
    'fused_scale_bias_relu_conv_bn',
    'fused_seqpool_cvm',
    'fused_softmax_mask',
    'fused_softmax_mask_upper_triangle',
    'fused_token_prune',
    'fusion_gru',
    'fusion_lstm',
    'fusion_repeated_fc_relu',
    'fusion_seqconv_eltadd_relu',
    'fusion_seqexpand_concat_fc',
    'fusion_seqpool_concat',
    'fusion_seqpool_cvm_concat',
    'fusion_squared_mat_sub',
    'fusion_transpose_flatten_concat',
    'gammaincc',
    'gammaln',
    'gather',
    'gather_nd',
    'gather_tree',
    'gaussian',
    'gaussian_inplace',
    'gaussian_random',
    'gcd',
    'gelu',
    'gemm_epilogue',
    'generate_proposals',
    'getitem',
    'global_gather',
    'global_scatter',
    'glu',
    'grad_add',
    'graph_khop_sampler',
    'graph_sample_neighbors',
    'graph_send_recv',
    'graph_send_ue_recv',
    'graph_send_uv',
    'greater_equal',
    'greater_than',
    'grid_sample',
    'group_norm',
    'gru',
    'gru_unit',
    'gumbel_softmax',
    'hardshrink',
    'hardsigmoid',
    'hardswish',
    'hardtanh',
    'hash',
    'heaviside',
    'hinge_loss',
    'histogram',
    'householder_product',
    'hsigmoid_loss',
    'huber_loss',
    'hypot',
    'i0',
    'i0e',
    'i1',
    'i1e',
    'identity_loss',
    'im2sequence',
    'imag',
    'increment',
    'index_add',
    'index_put',
    'index_sample',
    'index_select',
    'index_select_strided',
    'indices',
    'inner',
    'instance_norm',
    'interpolate_bilinear',
    'interpolate_nearest',
    'inverse',
    'iou_similarity',
    'is_empty',
    'isclose',
    'isfinite',
    'isinf',
    'isnan',
    'kl_div',
    'kldiv_loss',
    'kron',
    'kthvalue',
    'l1_norm',
    'label_smooth',
    'lamb_',
    'layer_norm',
    'lcm',
    'ldexp',
    'leaky_relu',
    'legacy_bilinear_interp',
    'legacy_crop',
    'legacy_expand',
    'legacy_generate_proposals',
    'legacy_nearest_interp',
    'lerp',
    'less_equal',
    'less_than',
    'lgamma',
    'limit_by_capacity',
    'linear',
    'linear_interp',
    'linspace',
    'llm_int8_linear',
    'local_response_norm',
    'log',
    'log10',
    'log1p',
    'log2',
    'log_loss',
    'log_sigmoid',
    'log_softmax',
    'logaddexp',
    'logcumsumexp',
    'logical_and',
    'logical_not',
    'logical_or',
    'logical_xor',
    'logit',
    'logsigmoid',
    'logspace',
    'logsumexp',
    'lookup_table',
    'lookup_table_dequant',
    'lower',
    'lp_pool2d',
    'lrn',
    'lstm',
    'lstsq',
    'lu',
    'lu_unpack',
    'margin_cross_entropy',
    'mask_as',
    'masked_fill',
    'masked_matmul',
    'masked_multihead_attention_',
    'masked_select',
    'match_matrix_tensor',
    'matmul',
    'matmul_with_flatten',
    'matrix_nms',
    'matrix_power',
    'matrix_rank',
    'matrix_rank_atol_rtol',
    'matrix_rank_tol',
    'max',
    'max_pool1d',
    'max_pool2d',
    'max_pool2d_v2',
    'max_pool2d_with_index',
    'max_pool3d_with_index',
    'maximum',
    'maxout',
    'maxpool',
    'mean',
    'mean_all',
    'median',
    'memcpy_d2h',
    'memcpy_h2d',
    'memory_efficient_attention',
    'merge_selected_rows',
    'merged_adam_',
    'merged_momentum_',
    'meshgrid',
    'min',
    'minimum',
    'mish',
    'mm',
    'mode',
    'momentum_',
    'moveaxis',
    'mp_allreduce_sum',
    'multi_dot',
    'multiclass_nms',
    'multiclass_nms3',
    'multihead_matmul',
    'multinomial',
    'multiplex',
    'multiply',
    'multiply_add',
    'mv',
    'nadam_',
    'nan_to_num',
    'nanmean',
    'nanmedian',
    'nansum',
    'nce',
    'nearest_interp',
    'nextafter',
    'nll_loss',
    'nms',
    'nonzero',
    'norm',
    'normal_like',
    'not_equal',
    'npu_identity',
    'number_count',
    'numel',
    'one_hot',
    'ones',
    'ones_like',
    'outer',
    'overlap_add',
    'p_norm',
    'p_recv',
    'p_recv_array',
    'p_send',
    'p_send_array',
    'pad',
    'pad3d',
    'partial_allgather',
    'partial_concat',
    'partial_sum',
    'pinv',
    'pixel_shuffle',
    'pixel_unshuffle',
    'poisson',
    'polygamma',
    'pool2d',
    'pool3d',
    'pow',
    'prelu',
    'prior_box',
    'prod',
    'prune_gate_by_capacity',
    'psroi_pool',
    'put_along_axis',
    'pyramid_hash',
    'qkv_unpack_mha',
    'qr',
    'quant_linear',
    'quantile',
    'quantize_linear',
    'rad2deg',
    'radam_',
    'randint',
    'random_routing',
    'randperm',
    'rank_attention',
    'read_file',
    'real',
    'reciprocal',
    'reduce',
    'reduce_as',
    'reduce_scatter',
    'reindex_graph',
    'relu',
    'relu6',
    'remainder',
    'renorm',
    'repeat_interleave',
    'repeat_interleave_with_tensor_index',
    'reshape',
    'resnet_basic_block',
    'resnet_unit',
    'reverse',
    'rms_norm',
    'rmsprop_',
    'rnn',
    'roi_align',
    'roi_pool',
    'roll',
    'rot90',
    'round',
    'row_conv',
    'rprop_',
    'rrelu',
    'rsqrt',
    'scale',
    'scaled_dot_product_attention',
    'scatter',
    'scatter_nd_add',
    'searchsorted',
    'segment_max',
    'segment_mean',
    'segment_min',
    'segment_pool',
    'segment_sum',
    'self_dp_attention',
    'selu',
    'send_u_recv',
    'send_ue_recv',
    'send_uv',
    'sequence_conv',
    'sequence_expand',
    'sequence_mask',
    'sequence_pad',
    'sequence_pool',
    'sequence_softmax',
    'sequence_unpad',
    'set',
    'set_value_with_tensor',
    'setitem',
    'sgd_',
    'shadow_output',
    'shape',
    'shard_index',
    'share_buffer',
    'share_data',
    'shuffle_batch',
    'shuffle_channel',
    'sigmoid',
    'sigmoid_cross_entropy_with_logits',
    'sign',
    'silu',
    'sin',
    'sinh',
    'skip_layernorm',
    'slice',
    'slogdet',
    'softmax',
    'softmax_with_cross_entropy',
    'softplus',
    'softshrink',
    'softsign',
    'solve',
    'sort',
    'sparse_attention',
    'sparse_coo_tensor',
    'sparse_momentum',
    'spectral_norm',
    'split',
    'split_with_num',
    'sqrt',
    'square',
    'squared_l2_norm',
    'squeeze',
    'squeeze_excitation_block',
    'stack',
    'standard_gamma',
    'stanh',
    'std',
    'stft',
    'strided_slice',
    'subtract',
    'sum',
    'svd',
    'swapaxes',
    'swiglu',
    'swish',
    'sync_batch_norm_',
    'sync_calc_stream',
    'take_along_axis',
    'tan',
    'tanh',
    'tanh_shrink',
    'tanhshrink',
    'tdm_child',
    'tdm_sampler',
    'temporal_shift',
    'thresholded_relu',
    'tile',
    'to_dense',
    'to_sparse_coo',
    'to_sparse_csr',
    'top_p_sampling',
    'topk',
    'topk_v1',
    'trace',
    'trans_layout',
    'transfer_layout',
    'transpose',
    'triangular_solve',
    'tril',
    'tril_indices',
    'tril_triu',
    'trilinear_interp',
    'triu',
    'triu_indices',
    'trunc',
    'truncated_gaussian_random',
    'unbind',
    'unfold',
    'uniform',
    'uniform_inplace',
    'uniform_random_batch_size_like',
    'uniform_random_like',
    'unique',
    'unique_consecutive',
    'unpool',
    'unpool3d',
    'unsqueeze',
    'unstack',
    'update_loss_scaling_',
    'upper',
    'values',
    'var',
    'variable_length_memory_efficient_attention',
    'view_dtype',
    'view_shape',
    'view_slice',
    'viterbi_decode',
    'warpctc',
    'warprnnt',
    'weight_dequantize',
    'weight_only_linear',
    'weight_quantize',
    'weighted_sample_neighbors',
    'where',
    'yolo_box',
    'yolo_box_head',
    'yolo_box_post',
    'yolo_loss',
    'zeros',
    'zeros_like',
]
