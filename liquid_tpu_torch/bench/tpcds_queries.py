"""TPC-DS query corpus over the generated tables.

Equivalent role to the reference's TPC-DS suite (liquid-cache
`benchmark/tpcds/manifest.json` -- an 85-query manifest -- plus
`tpcds_client.rs`; the reference mutes several queries for upstream
DataFusion bugs, `tpcds_notes.md`).  This corpus covers all 85 manifest
query numbers plus 10 extra shapes (q10 q18 q31 q37 q45 q53 q63 q73
q81 q82), 95 total, written in the official parameter style and
adapted only where the spec references columns the 24-table generator
does not model.  Every query is differentially tested against an
independent pandas oracle (`tpcds_ref.py`).

Host copy of `liquid_tpu/bench/tpcds_queries.py`: the port imports nothing of
the reference package.
"""

QUERIES = {
    18: """
select i_item_id, ca_country, ca_state, ca_county,
    avg(cs_quantity) as agg1, avg(cs_list_price) as agg2,
    avg(cs_coupon_amt) as agg3, avg(cs_sales_price) as agg4,
    avg(cs_net_profit) as agg5, avg(c_birth_year) as agg6,
    avg(cd1.cd_dep_count) as agg7
from catalog_sales, customer_demographics cd1,
     customer_demographics cd2, customer, customer_address,
     date_dim, item
where cs_sold_date_sk = d_date_sk
    and cs_item_sk = i_item_sk
    and cs_cdemo_sk = cd1.cd_demo_sk
    and cs_customer_sk = c_customer_sk
    and cd1.cd_gender = 'F'
    and cd1.cd_education_status = 'Unknown'
    and c_current_cdemo_sk = cd2.cd_demo_sk
    and c_current_addr_sk = ca_address_sk
    and c_birth_month in (1, 6, 8, 9, 12, 2)
    and d_year = 1998
    and ca_state in ('MS', 'IN', 'ND', 'OK', 'NM', 'VA', 'MI')
group by rollup(i_item_id, ca_country, ca_state, ca_county)
order by ca_country nulls first, ca_state nulls first,
    ca_county nulls first, i_item_id nulls first
limit 100
""",
    22: """
select i_product_name, i_brand, i_class, i_category,
    avg(inv_quantity_on_hand) as qoh
from inventory, date_dim, item
where inv_date_sk = d_date_sk
    and inv_item_sk = i_item_sk
    and d_month_seq between 24 and 35
group by rollup(i_product_name, i_brand, i_class, i_category)
order by qoh, i_product_name nulls first, i_brand nulls first,
    i_class nulls first, i_category nulls first
limit 100
""",
    27: """
select i_item_id, s_state, grouping(s_state) as g_state,
    avg(ss_quantity) as agg1, avg(ss_list_price) as agg2,
    avg(ss_coupon_amt) as agg3, avg(ss_sales_price) as agg4
from store_sales, customer_demographics, date_dim, store, item
where ss_sold_date_sk = d_date_sk
    and ss_item_sk = i_item_sk
    and ss_store_sk = s_store_sk
    and ss_cdemo_sk = cd_demo_sk
    and cd_gender = 'M'
    and cd_marital_status = 'S'
    and cd_education_status = 'College'
    and d_year = 2002
    and s_state in ('AL', 'CA', 'GA', 'IL', 'IN', 'KS')
group by rollup(i_item_id, s_state)
order by i_item_id nulls first, s_state nulls first
limit 100
""",
    36: """
select sum(ss_net_profit) / sum(ss_ext_sales_price) as gross_margin,
    i_category, i_class,
    grouping(i_category) + grouping(i_class) as lochierarchy,
    rank() over (partition by grouping(i_category) + grouping(i_class),
        case when grouping(i_class) = 0 then i_category end
        order by sum(ss_net_profit) / sum(ss_ext_sales_price) asc)
        as rank_within_parent
from store_sales, date_dim d1, item, store
where d1.d_year = 2001
    and d1.d_date_sk = ss_sold_date_sk
    and i_item_sk = ss_item_sk
    and s_store_sk = ss_store_sk
    and s_state in ('AL', 'CA', 'GA', 'IL', 'IN', 'KS')
group by rollup(i_category, i_class)
order by lochierarchy desc,
    case when lochierarchy = 0 then i_category end nulls first,
    rank_within_parent
limit 100
""",
    86: """
select sum(ws_net_paid) as total_sum, i_category, i_class,
    grouping(i_category) + grouping(i_class) as lochierarchy,
    rank() over (partition by grouping(i_category) + grouping(i_class),
        case when grouping(i_class) = 0 then i_category end
        order by sum(ws_net_paid) desc) as rank_within_parent
from web_sales, date_dim d1, item
where d1.d_month_seq between 24 and 35
    and d1.d_date_sk = ws_sold_date_sk
    and i_item_sk = ws_item_sk
group by rollup(i_category, i_class)
order by lochierarchy desc,
    case when lochierarchy = 0 then i_category end nulls first,
    rank_within_parent
limit 100
""",
    12: """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
    sum(ws_ext_sales_price) as itemrevenue,
    sum(ws_ext_sales_price) * 100 /
        sum(sum(ws_ext_sales_price)) over (partition by i_class)
        as revenueratio
from web_sales, item, date_dim
where ws_item_sk = i_item_sk
    and i_category in ('Sports', 'Books', 'Home')
    and ws_sold_date_sk = d_date_sk
    and d_date between cast('1999-02-22' as date)
        and (cast('1999-02-22' as date) + interval '30' day)
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
""",
    20: """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
    sum(cs_ext_sales_price) as itemrevenue,
    sum(cs_ext_sales_price) * 100 /
        sum(sum(cs_ext_sales_price)) over (partition by i_class)
        as revenueratio
from catalog_sales, item, date_dim
where cs_item_sk = i_item_sk
    and i_category in ('Sports', 'Books', 'Home')
    and cs_sold_date_sk = d_date_sk
    and d_date between cast('1999-02-22' as date)
        and (cast('1999-02-22' as date) + interval '30' day)
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
""",
    47: """
with v1 as (
    select i_category, i_brand, s_store_name, s_company_name,
        d_year, d_moy, sum(ss_sales_price) as sum_sales,
        avg(sum(ss_sales_price)) over (partition by i_category, i_brand,
            s_store_name, s_company_name, d_year) as avg_monthly_sales,
        rank() over (partition by i_category, i_brand, s_store_name,
            s_company_name order by d_year, d_moy) as rn
    from item, store_sales, date_dim, store
    where ss_item_sk = i_item_sk
        and ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and (d_year = 1999
             or (d_year = 1998 and d_moy = 12)
             or (d_year = 2000 and d_moy = 1))
    group by i_category, i_brand, s_store_name, s_company_name,
        d_year, d_moy),
v2 as (
    select v1.i_category as i_category, v1.s_store_name as s_store_name,
        v1.s_company_name as s_company_name, v1.d_year as d_year,
        v1.d_moy as d_moy, v1.avg_monthly_sales as avg_monthly_sales,
        v1.sum_sales as sum_sales,
        v1_lag.sum_sales as psum, v1_lead.sum_sales as nsum
    from v1, v1 v1_lag, v1 v1_lead
    where v1.i_category = v1_lag.i_category
        and v1.i_brand = v1_lag.i_brand
        and v1.s_store_name = v1_lag.s_store_name
        and v1.s_company_name = v1_lag.s_company_name
        and v1.rn = v1_lag.rn + 1
        and v1.i_category = v1_lead.i_category
        and v1.i_brand = v1_lead.i_brand
        and v1.s_store_name = v1_lead.s_store_name
        and v1.s_company_name = v1_lead.s_company_name
        and v1.rn = v1_lead.rn - 1)
select * from v2
where d_year = 1999
    and avg_monthly_sales > 0
    and abs(sum_sales - avg_monthly_sales) / avg_monthly_sales > 0.1
order by sum_sales - avg_monthly_sales, s_store_name, d_moy
limit 100
""",
    51: """
with web_v1 as (
    select ws_item_sk as item_sk, d_date,
        sum(sum(ws_sales_price)) over (partition by ws_item_sk
            order by d_date rows between unbounded preceding
            and current row) as cume_sales
    from web_sales, date_dim
    where ws_sold_date_sk = d_date_sk
        and d_month_seq between 24 and 27
        and ws_item_sk is not null
    group by ws_item_sk, d_date),
store_v1 as (
    select ss_item_sk as item_sk, d_date,
        sum(sum(ss_sales_price)) over (partition by ss_item_sk
            order by d_date rows between unbounded preceding
            and current row) as cume_sales
    from store_sales, date_dim
    where ss_sold_date_sk = d_date_sk
        and d_month_seq between 24 and 27
        and ss_item_sk is not null
    group by ss_item_sk, d_date)
select * from (
    select item_sk, d_date, web_sales, store_sales,
        max(web_sales) over (partition by item_sk order by d_date
            rows between unbounded preceding and current row)
            as web_cumulative,
        max(store_sales) over (partition by item_sk order by d_date
            rows between unbounded preceding and current row)
            as store_cumulative
    from (
        select case when web.item_sk is not null then web.item_sk
                    else store.item_sk end as item_sk,
            case when web.d_date is not null then web.d_date
                 else store.d_date end as d_date,
            web.cume_sales as web_sales,
            store.cume_sales as store_sales
        from web_v1 web full outer join store_v1 store
            on (web.item_sk = store.item_sk and web.d_date = store.d_date)
        ) x ) y
where web_cumulative > store_cumulative
order by item_sk, d_date
limit 100
""",
    98: """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
    sum(ss_ext_sales_price) as itemrevenue,
    sum(ss_ext_sales_price) * 100 /
        sum(sum(ss_ext_sales_price)) over (partition by i_class)
        as revenueratio
from store_sales, item, date_dim
where ss_item_sk = i_item_sk
    and i_category in ('Sports', 'Books', 'Home')
    and ss_sold_date_sk = d_date_sk
    and d_date between cast('1999-02-22' as date)
        and (cast('1999-02-22' as date) + interval '30' day)
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
""",
    3: """
select d_year, i_brand_id as brand_id, i_brand as brand,
    sum(ss_ext_sales_price) as sum_agg
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
    and store_sales.ss_item_sk = item.i_item_sk
    and item.i_manufact_id = 128
    and dt.d_moy = 11
group by d_year, i_brand_id, i_brand
order by d_year, sum_agg desc, brand_id
limit 100
""",
    7: """
select i_item_id, avg(ss_quantity) as agg1, avg(ss_list_price) as agg2,
    avg(ss_coupon_amt) as agg3, avg(ss_sales_price) as agg4
from store_sales, customer_demographics, date_dim, item, promotion
where ss_sold_date_sk = d_date_sk
    and ss_item_sk = i_item_sk
    and ss_cdemo_sk = cd_demo_sk
    and ss_promo_sk = p_promo_sk
    and cd_gender = 'M'
    and cd_marital_status = 'S'
    and cd_education_status = 'College'
    and (p_channel_email = 'N' or p_channel_event = 'N')
    and d_year = 2000
group by i_item_id
order by i_item_id
limit 100
""",
    13: """
select avg(ss_quantity) as a1, avg(ss_ext_sales_price) as a2,
    avg(ss_ext_wholesale_cost) as a3, sum(ss_ext_wholesale_cost) as a4
from store_sales, store, customer_demographics,
     household_demographics, customer_address, date_dim
where s_store_sk = ss_store_sk
    and ss_sold_date_sk = d_date_sk and d_year = 2001
    and ((ss_hdemo_sk = hd_demo_sk
        and cd_demo_sk = ss_cdemo_sk
        and cd_marital_status = 'M'
        and cd_education_status = 'Advanced Degree'
        and ss_sales_price between 100.00 and 150.00
        and hd_dep_count = 3)
    or (ss_hdemo_sk = hd_demo_sk
        and cd_demo_sk = ss_cdemo_sk
        and cd_marital_status = 'S'
        and cd_education_status = 'College'
        and ss_sales_price between 50.00 and 100.00
        and hd_dep_count = 1)
    or (ss_hdemo_sk = hd_demo_sk
        and cd_demo_sk = ss_cdemo_sk
        and cd_marital_status = 'W'
        and cd_education_status = '2 yr Degree'
        and ss_sales_price between 150.00 and 200.00
        and hd_dep_count = 1))
    and ((ss_addr_sk = ca_address_sk
        and ca_country = 'United States'
        and ca_state in ('TX', 'OH', 'TX')
        and ss_net_profit between 100 and 200)
    or (ss_addr_sk = ca_address_sk
        and ca_country = 'United States'
        and ca_state in ('OR', 'NM', 'KY')
        and ss_net_profit between 150 and 300)
    or (ss_addr_sk = ca_address_sk
        and ca_country = 'United States'
        and ca_state in ('VA', 'TX', 'MS')
        and ss_net_profit between 50 and 250))
""",
    19: """
select i_brand_id as brand_id, i_brand as brand, i_manufact_id,
    sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item, customer, customer_address, store
where d_date_sk = ss_sold_date_sk
    and ss_item_sk = i_item_sk
    and i_manager_id = 8
    and d_moy = 11
    and d_year = 1998
    and ss_customer_sk = c_customer_sk
    and c_current_addr_sk = ca_address_sk
    and ss_store_sk = s_store_sk
    and substring(ca_zip, 1, 5) <> substring(s_city, 1, 5)
group by i_brand_id, i_brand, i_manufact_id
order by ext_price desc, brand_id, i_manufact_id
limit 100
""",
    26: """
select i_item_id, avg(cs_quantity) as agg1, avg(cs_list_price) as agg2,
    avg(cs_coupon_amt) as agg3, avg(cs_sales_price) as agg4
from catalog_sales, customer_demographics, date_dim, item, promotion
where cs_sold_date_sk = d_date_sk
    and cs_item_sk = i_item_sk
    and cs_cdemo_sk = cd_demo_sk
    and cs_promo_sk = p_promo_sk
    and cd_gender = 'M'
    and cd_marital_status = 'S'
    and cd_education_status = 'College'
    and (p_channel_email = 'N' or p_channel_event = 'N')
    and d_year = 2000
group by i_item_id
order by i_item_id
limit 100
""",
    42: """
select d_year, i_category, sum(ss_ext_sales_price) as total_sales
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
    and store_sales.ss_item_sk = item.i_item_sk
    and item.i_manager_id = 1
    and dt.d_moy = 11
    and dt.d_year = 2000
group by d_year, i_category
order by total_sales desc, d_year, i_category
limit 100
""",
    43: """
select s_store_name, s_store_id,
    sum(case when d_day_name = 'Sunday' then ss_sales_price else null end)
        as sun_sales,
    sum(case when d_day_name = 'Monday' then ss_sales_price else null end)
        as mon_sales,
    sum(case when d_day_name = 'Friday' then ss_sales_price else null end)
        as fri_sales,
    sum(case when d_day_name = 'Saturday' then ss_sales_price else null end)
        as sat_sales
from date_dim, store_sales, store
where d_date_sk = ss_sold_date_sk
    and s_store_sk = ss_store_sk
    and s_gmt_offset = -5
    and d_year = 2000
group by s_store_name, s_store_id
order by s_store_name, s_store_id
limit 100
""",
    52: """
select d_year, i_brand_id as brand_id, i_brand as brand,
    sum(ss_ext_sales_price) as ext_price
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
    and store_sales.ss_item_sk = item.i_item_sk
    and item.i_manager_id = 1
    and dt.d_moy = 11
    and dt.d_year = 2000
group by d_year, i_brand_id, i_brand
order by d_year, ext_price desc, brand_id
limit 100
""",
    55: """
select i_brand_id as brand_id, i_brand as brand,
    sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
    and ss_item_sk = i_item_sk
    and i_manager_id = 28
    and d_moy = 11
    and d_year = 1999
group by i_brand_id, i_brand
order by ext_price desc, brand_id
limit 100
""",
    73: """
select c_last_name, c_first_name, c_customer_sk as c_salutation,
    ss_ticket_number, cnt
from (
    select ss_ticket_number, ss_customer_sk, count(*) as cnt
    from store_sales, date_dim, store, household_demographics
    where store_sales.ss_sold_date_sk = date_dim.d_date_sk
        and store_sales.ss_store_sk = store.s_store_sk
        and store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
        and date_dim.d_dom between 1 and 2
        and (household_demographics.hd_buy_potential = '>10000'
            or household_demographics.hd_buy_potential = 'Unknown')
        and household_demographics.hd_vehicle_count > 0
        and date_dim.d_year in (1999, 2000, 2001)
        and store.s_county in ('Williamson County', 'Franklin County',
                               'Bronx County', 'Orange County')
    group by ss_ticket_number, ss_customer_sk
) as dj, customer
where ss_customer_sk = c_customer_sk and cnt between 1 and 5
order by cnt desc, c_last_name asc, ss_ticket_number
limit 1000
""",
    90: """
select cast(amc as double) / cast(pmc as double) as am_pm_ratio
from (select count(*) as amc from web_sales, household_demographics,
        time_dim
    where ws_sold_time_sk = time_dim.t_time_sk
        and ws_hdemo_sk = household_demographics.hd_demo_sk
        and time_dim.t_hour between 8 and 9
        and household_demographics.hd_dep_count = 6) as at,
    (select count(*) as pmc from web_sales, household_demographics,
        time_dim
    where ws_sold_time_sk = time_dim.t_time_sk
        and ws_hdemo_sk = household_demographics.hd_demo_sk
        and time_dim.t_hour between 19 and 20
        and household_demographics.hd_dep_count = 6) as pt
order by am_pm_ratio
limit 100
""",
    93: """
select ss_customer_sk, sum(act_sales) as sumsales
from (
    select ss_customer_sk,
        case when sr_return_quantity is not null
            then (ss_quantity - sr_return_quantity) * ss_sales_price
            else ss_quantity * ss_sales_price end as act_sales
    from store_sales left outer join store_returns
        on (sr_item_sk = ss_item_sk and sr_ticket_number = ss_ticket_number)
) as t
group by ss_customer_sk
order by sumsales desc, ss_customer_sk
limit 100
""",
    97: """
with ssci as (
    select ss_customer_sk as customer_sk, ss_item_sk as item_sk
    from store_sales, date_dim
    where ss_sold_date_sk = d_date_sk and d_month_seq between 24 and 35
    group by ss_customer_sk, ss_item_sk),
csci as (
    select cs_customer_sk as customer_sk, cs_item_sk as item_sk
    from catalog_sales, date_dim
    where cs_sold_date_sk = d_date_sk and d_month_seq between 24 and 35
    group by cs_customer_sk, cs_item_sk)
select
    sum(case when ssci.customer_sk is not null and csci.customer_sk is null
        then 1 else 0 end) as store_only,
    sum(case when ssci.customer_sk is null and csci.customer_sk is not null
        then 1 else 0 end) as catalog_only,
    sum(case when ssci.customer_sk is not null
        and csci.customer_sk is not null then 1 else 0 end)
        as store_and_catalog
from ssci full outer join csci on (ssci.customer_sk = csci.customer_sk
    and ssci.item_sk = csci.item_sk)
limit 100
""",
    96: """
select count(*) as cnt
from store_sales, household_demographics, time_dim, store
where ss_sold_time_sk = time_dim.t_time_sk
    and ss_hdemo_sk = household_demographics.hd_demo_sk
    and ss_store_sk = s_store_sk
    and time_dim.t_hour = 20
    and time_dim.t_minute >= 30
    and household_demographics.hd_dep_count = 7
    and store.s_store_name = 'store a'
order by cnt
limit 100
""",
    15: """
select ca_zip, sum(cs_sales_price) as sum_sales
from catalog_sales, customer, customer_address, date_dim
where cs_customer_sk = c_customer_sk
    and c_current_addr_sk = ca_address_sk
    and (substr(ca_zip, 1, 2) in ('85', '86', '88', '83', '80', '81')
         or ca_state in ('CA', 'WA', 'GA')
         or cs_sales_price > 500)
    and cs_sold_date_sk = d_date_sk
    and d_qoy = 2 and d_year = 2001
group by ca_zip
order by ca_zip
limit 100
""",
    25: """
select i_item_id, i_item_desc, s_store_id, s_store_name,
    sum(ss_net_profit) as store_sales_profit,
    sum(sr_net_loss) as store_returns_loss,
    sum(cs_net_profit) as catalog_sales_profit
from store_sales, store_returns, catalog_sales, date_dim d1,
     date_dim d2, date_dim d3, store, item
where d1.d_moy = 4 and d1.d_year = 2001
    and d1.d_date_sk = ss_sold_date_sk
    and i_item_sk = ss_item_sk
    and s_store_sk = ss_store_sk
    and ss_customer_sk = sr_customer_sk
    and ss_item_sk = sr_item_sk
    and ss_ticket_number = sr_ticket_number
    and sr_returned_date_sk = d2.d_date_sk
    and d2.d_moy between 4 and 10 and d2.d_year = 2001
    and sr_customer_sk = cs_customer_sk
    and sr_item_sk = cs_item_sk
    and cs_sold_date_sk = d3.d_date_sk
    and d3.d_moy between 4 and 10 and d3.d_year = 2001
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
""",
    29: """
select i_item_id, i_item_desc, s_store_id, s_store_name,
    sum(ss_quantity) as store_sales_quantity,
    sum(sr_return_quantity) as store_returns_quantity,
    sum(cs_quantity) as catalog_sales_quantity
from store_sales, store_returns, catalog_sales, date_dim d1,
     date_dim d2, date_dim d3, store, item
where d1.d_moy = 9 and d1.d_year = 1999
    and d1.d_date_sk = ss_sold_date_sk
    and i_item_sk = ss_item_sk
    and s_store_sk = ss_store_sk
    and ss_customer_sk = sr_customer_sk
    and ss_item_sk = sr_item_sk
    and ss_ticket_number = sr_ticket_number
    and sr_returned_date_sk = d2.d_date_sk
    and d2.d_moy between 9 and 12 and d2.d_year = 1999
    and sr_customer_sk = cs_customer_sk
    and sr_item_sk = cs_item_sk
    and cs_sold_date_sk = d3.d_date_sk
    and d3.d_year in (1999, 2000, 2001)
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
""",
    37: """
select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim, catalog_sales
where i_current_price between 68 and 98
    and inv_item_sk = i_item_sk
    and d_date_sk = inv_date_sk
    and d_date between cast('2000-02-01' as date)
        and (cast('2000-02-01' as date) + interval '60' day)
    and i_manufact_id in (677, 940, 694, 808)
    and inv_quantity_on_hand between 100 and 500
    and cs_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id
limit 100
""",
    82: """
select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim, store_sales
where i_current_price between 62 and 92
    and inv_item_sk = i_item_sk
    and d_date_sk = inv_date_sk
    and d_date between cast('2000-05-25' as date)
        and (cast('2000-05-25' as date) + interval '60' day)
    and i_manufact_id in (129, 270, 821, 423)
    and inv_quantity_on_hand between 100 and 500
    and ss_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id
limit 100
""",
    48: """
select sum(ss_quantity) as total
from store_sales, store, customer_demographics, customer_address,
     date_dim
where s_store_sk = ss_store_sk
    and ss_sold_date_sk = d_date_sk and d_year = 2000
    and ((cd_demo_sk = ss_cdemo_sk and cd_marital_status = 'M'
          and cd_education_status = '4 yr Degree'
          and ss_sales_price between 100.00 and 150.00)
         or (cd_demo_sk = ss_cdemo_sk and cd_marital_status = 'D'
             and cd_education_status = '2 yr Degree'
             and ss_sales_price between 50.00 and 100.00)
         or (cd_demo_sk = ss_cdemo_sk and cd_marital_status = 'S'
             and cd_education_status = 'College'
             and ss_sales_price between 150.00 and 200.00))
    and ((ss_addr_sk = ca_address_sk and ca_country = 'United States'
          and ca_state in ('CO', 'OH', 'TX')
          and ss_net_profit between 0 and 2000)
         or (ss_addr_sk = ca_address_sk and ca_country = 'United States'
             and ca_state in ('OR', 'MN', 'KY')
             and ss_net_profit between 150 and 3000)
         or (ss_addr_sk = ca_address_sk and ca_country = 'United States'
             and ca_state in ('VA', 'CA', 'MS')
             and ss_net_profit between 50 and 25000))
""",
    50: """
select s_store_name, s_company_name, s_county,
    sum(case when (sr_returned_date_sk - ss_sold_date_sk <= 30)
        then 1 else 0 end) as "30 days",
    sum(case when (sr_returned_date_sk - ss_sold_date_sk > 30)
        and (sr_returned_date_sk - ss_sold_date_sk <= 60)
        then 1 else 0 end) as "31-60 days",
    sum(case when (sr_returned_date_sk - ss_sold_date_sk > 60)
        and (sr_returned_date_sk - ss_sold_date_sk <= 90)
        then 1 else 0 end) as "61-90 days",
    sum(case when (sr_returned_date_sk - ss_sold_date_sk > 90)
        and (sr_returned_date_sk - ss_sold_date_sk <= 120)
        then 1 else 0 end) as "91-120 days",
    sum(case when (sr_returned_date_sk - ss_sold_date_sk > 120)
        then 1 else 0 end) as ">120 days"
from store_sales, store_returns, store, date_dim d1, date_dim d2
where d2.d_year = 2001 and d2.d_moy = 8
    and ss_ticket_number = sr_ticket_number
    and ss_item_sk = sr_item_sk
    and ss_sold_date_sk = d1.d_date_sk
    and sr_returned_date_sk = d2.d_date_sk
    and ss_customer_sk = sr_customer_sk
    and ss_store_sk = s_store_sk
group by s_store_name, s_company_name, s_county
order by s_store_name, s_company_name, s_county
limit 100
""",
    65: """
select s_store_name, i_item_desc, sc.revenue, i_current_price,
    i_wholesale_cost, i_brand
from store, item,
    (select ss_store_sk, avg(revenue) as ave
     from (select ss_store_sk, ss_item_sk, sum(ss_sales_price) as revenue
           from store_sales, date_dim
           where ss_sold_date_sk = d_date_sk
               and d_month_seq between 24 and 35
           group by ss_store_sk, ss_item_sk) sa
     group by ss_store_sk) sb,
    (select ss_store_sk, ss_item_sk, sum(ss_sales_price) as revenue
     from store_sales, date_dim
     where ss_sold_date_sk = d_date_sk
         and d_month_seq between 24 and 35
     group by ss_store_sk, ss_item_sk) sc
where sb.ss_store_sk = sc.ss_store_sk
    and sc.revenue <= 0.1 * sb.ave
    and s_store_sk = sc.ss_store_sk
    and i_item_sk = sc.ss_item_sk
order by s_store_name, i_item_desc
limit 100
""",
    79: """
select c_last_name, c_first_name,
    substr(s_city, 1, 30) as city30, ss_ticket_number, amt, profit
from (select ss_ticket_number, ss_customer_sk, store.s_city,
          sum(ss_coupon_amt) amt, sum(ss_net_profit) profit
      from store_sales, date_dim, store, household_demographics
      where store_sales.ss_sold_date_sk = date_dim.d_date_sk
          and store_sales.ss_store_sk = store.s_store_sk
          and store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
          and (household_demographics.hd_dep_count = 6
               or household_demographics.hd_vehicle_count > 2)
          and date_dim.d_dow = 1
          and date_dim.d_year in (1999, 2000, 2001)
          and store.s_number_employees between 200 and 295
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk,
          store.s_city) ms, customer
where ss_customer_sk = c_customer_sk
order by c_last_name, c_first_name, city30, profit, ss_ticket_number
limit 100
""",
    28: """
select *
from (select avg(ss_list_price) b1_lp, count(ss_list_price) b1_cnt,
          count(distinct ss_list_price) b1_cntd
      from store_sales
      where ss_quantity between 0 and 5
          and (ss_list_price between 8 and 18
               or ss_coupon_amt between 459 and 1459
               or ss_wholesale_cost between 57 and 77)) b1,
    (select avg(ss_list_price) b2_lp, count(ss_list_price) b2_cnt,
         count(distinct ss_list_price) b2_cntd
     from store_sales
     where ss_quantity between 6 and 10
         and (ss_list_price between 90 and 100
              or ss_coupon_amt between 2323 and 3323
              or ss_wholesale_cost between 31 and 51)) b2,
    (select avg(ss_list_price) b3_lp, count(ss_list_price) b3_cnt,
         count(distinct ss_list_price) b3_cntd
     from store_sales
     where ss_quantity between 11 and 15
         and (ss_list_price between 142 and 152
              or ss_coupon_amt between 12214 and 13214
              or ss_wholesale_cost between 79 and 99)) b3,
    (select avg(ss_list_price) b4_lp, count(ss_list_price) b4_cnt,
         count(distinct ss_list_price) b4_cntd
     from store_sales
     where ss_quantity between 16 and 20
         and (ss_list_price between 135 and 145
              or ss_coupon_amt between 6071 and 7071
              or ss_wholesale_cost between 38 and 58)) b4
limit 100
""",
    33: """
with ss as (
    select i_manufact_id, sum(ss_ext_sales_price) total_sales
    from store_sales, date_dim, customer_address, item
    where i_manufact_id in (select i_manufact_id from item
                            where i_category in ('Electronics'))
        and ss_item_sk = i_item_sk
        and ss_sold_date_sk = d_date_sk
        and d_year = 1998 and d_moy = 5
        and ss_addr_sk = ca_address_sk
        and ca_gmt_offset = -5
    group by i_manufact_id),
cs as (
    select i_manufact_id, sum(cs_ext_sales_price) total_sales
    from catalog_sales, date_dim, customer_address, item
    where i_manufact_id in (select i_manufact_id from item
                            where i_category in ('Electronics'))
        and cs_item_sk = i_item_sk
        and cs_sold_date_sk = d_date_sk
        and d_year = 1998 and d_moy = 5
        and cs_addr_sk = ca_address_sk
        and ca_gmt_offset = -5
    group by i_manufact_id),
ws as (
    select i_manufact_id, sum(ws_ext_sales_price) total_sales
    from web_sales, date_dim, customer_address, item
    where i_manufact_id in (select i_manufact_id from item
                            where i_category in ('Electronics'))
        and ws_item_sk = i_item_sk
        and ws_sold_date_sk = d_date_sk
        and d_year = 1998 and d_moy = 5
        and ws_addr_sk = ca_address_sk
        and ca_gmt_offset = -5
    group by i_manufact_id)
select i_manufact_id, sum(total_sales) total_sales
from (select * from ss union all select * from cs
      union all select * from ws) tmp1
group by i_manufact_id
order by total_sales, i_manufact_id
limit 100
""",
    34: """
select c_last_name, c_first_name, c_salutation,
    c_preferred_cust_flag, ss_ticket_number, cnt
from (select ss_ticket_number, ss_customer_sk, count(*) cnt
      from store_sales, date_dim, store, household_demographics
      where store_sales.ss_sold_date_sk = date_dim.d_date_sk
          and store_sales.ss_store_sk = store.s_store_sk
          and store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
          and (date_dim.d_dom between 1 and 3
               or date_dim.d_dom between 25 and 28)
          and (household_demographics.hd_buy_potential = '>10000'
               or household_demographics.hd_buy_potential = 'Unknown')
          and household_demographics.hd_vehicle_count > 0
          and household_demographics.hd_dep_count /
              household_demographics.hd_vehicle_count > 1.2
          and date_dim.d_year in (1999, 2000, 2001)
          and store.s_county in ('Williamson County', 'Walker County',
                                 'Ziebach County', 'Ziebach County')
      group by ss_ticket_number, ss_customer_sk) dn, customer
where ss_customer_sk = c_customer_sk
    and cnt between 15 and 20
order by c_last_name, c_first_name, c_salutation,
    c_preferred_cust_flag desc, ss_ticket_number
""",
    38: """
select count(*) from (
    select distinct c_last_name, c_first_name, d_date
    from store_sales, date_dim, customer
    where store_sales.ss_sold_date_sk = date_dim.d_date_sk
        and store_sales.ss_customer_sk = customer.c_customer_sk
        and d_month_seq between 24 and 35
    intersect
    select distinct c_last_name, c_first_name, d_date
    from catalog_sales, date_dim, customer
    where catalog_sales.cs_sold_date_sk = date_dim.d_date_sk
        and catalog_sales.cs_customer_sk = customer.c_customer_sk
        and d_month_seq between 24 and 35
    intersect
    select distinct c_last_name, c_first_name, d_date
    from web_sales, date_dim, customer
    where web_sales.ws_sold_date_sk = date_dim.d_date_sk
        and web_sales.ws_customer_sk = customer.c_customer_sk
        and d_month_seq between 24 and 35
) hot_cust
limit 100
""",
    41: """
select distinct i_product_name
from item i1
where i_manufact_id between 738 and 778
    and (select count(*) as item_cnt from item
         where i_manufact_id = i1.i_manufact_id
             and i_category = 'Women') > 0
order by i_product_name
limit 100
""",
    45: """
select ca_zip, ca_city, sum(ws_sales_price) as sum_sales
from web_sales, customer, customer_address, date_dim, item
where ws_customer_sk = c_customer_sk
    and c_current_addr_sk = ca_address_sk
    and ws_item_sk = i_item_sk
    and (substr(ca_zip, 1, 5) in ('85669', '86197', '88274', '83405',
                                  '86475', '85392', '85460', '80348',
                                  '81792')
         or i_item_id in (select i_item_id from item
                          where i_item_sk in (2, 3, 5, 7, 11, 13,
                                              17, 19, 23, 29)))
    and ws_sold_date_sk = d_date_sk
    and d_qoy = 2 and d_year = 2001
group by ca_zip, ca_city
order by ca_zip, ca_city
limit 100
""",
    46: """
select c_last_name, c_first_name, ca_city, bought_city,
    ss_ticket_number, amt, profit
from (select ss_ticket_number, ss_customer_sk,
          ca_city bought_city, sum(ss_coupon_amt) amt,
          sum(ss_net_profit) profit
      from store_sales, date_dim, store, household_demographics,
          customer_address
      where store_sales.ss_sold_date_sk = date_dim.d_date_sk
          and store_sales.ss_store_sk = store.s_store_sk
          and store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
          and store_sales.ss_addr_sk = customer_address.ca_address_sk
          and (household_demographics.hd_dep_count = 4
               or household_demographics.hd_vehicle_count = 3)
          and date_dim.d_dow in (6, 0)
          and date_dim.d_year in (1999, 2000, 2001)
          and store.s_city in ('city1', 'city2', 'city3', 'city4',
                               'city5')
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk, ca_city)
    dn, customer, customer_address current_addr
where ss_customer_sk = c_customer_sk
    and customer.c_current_addr_sk = current_addr.ca_address_sk
    and current_addr.ca_city <> bought_city
order by c_last_name, c_first_name, ca_city, bought_city,
    ss_ticket_number
limit 100
""",
    53: """
select manufact_id, sum_sales, avg_quarterly_sales
from (select i_manufact_id manufact_id,
          sum(ss_sales_price) sum_sales,
          avg(sum(ss_sales_price)) over (partition by i_manufact_id)
              avg_quarterly_sales
      from item, store_sales, date_dim, store
      where ss_item_sk = i_item_sk
          and ss_sold_date_sk = d_date_sk
          and ss_store_sk = s_store_sk
          and d_month_seq in (24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
                              34, 35)
          and i_category in ('Books', 'Children', 'Electronics')
      group by i_manufact_id, d_qoy) tmp1
where case when avg_quarterly_sales > 0
          then abs(sum_sales - avg_quarterly_sales) /
               avg_quarterly_sales
          else null end > 0.1
order by avg_quarterly_sales, sum_sales, manufact_id
limit 100
""",
    56: """
with ss as (
    select i_item_id, sum(ss_ext_sales_price) total_sales
    from store_sales, date_dim, customer_address, item
    where i_item_id in (select i_item_id from item
                        where i_category in ('Music'))
        and ss_item_sk = i_item_sk
        and ss_sold_date_sk = d_date_sk
        and d_year = 2001 and d_moy = 2
        and ss_addr_sk = ca_address_sk
        and ca_gmt_offset = -5
    group by i_item_id),
cs as (
    select i_item_id, sum(cs_ext_sales_price) total_sales
    from catalog_sales, date_dim, customer_address, item
    where i_item_id in (select i_item_id from item
                        where i_category in ('Music'))
        and cs_item_sk = i_item_sk
        and cs_sold_date_sk = d_date_sk
        and d_year = 2001 and d_moy = 2
        and cs_addr_sk = ca_address_sk
        and ca_gmt_offset = -5
    group by i_item_id),
ws as (
    select i_item_id, sum(ws_ext_sales_price) total_sales
    from web_sales, date_dim, customer_address, item
    where i_item_id in (select i_item_id from item
                        where i_category in ('Music'))
        and ws_item_sk = i_item_sk
        and ws_sold_date_sk = d_date_sk
        and d_year = 2001 and d_moy = 2
        and ws_addr_sk = ca_address_sk
        and ca_gmt_offset = -5
    group by i_item_id)
select i_item_id, sum(total_sales) total_sales
from (select * from ss union all select * from cs
      union all select * from ws) tmp1
group by i_item_id
order by total_sales, i_item_id
limit 100
""",
    6: """
select a.ca_state state, count(*) cnt
from customer_address a, customer c, store_sales s, date_dim d, item i
where a.ca_address_sk = c.c_current_addr_sk
    and c.c_customer_sk = s.ss_customer_sk
    and s.ss_sold_date_sk = d.d_date_sk
    and s.ss_item_sk = i.i_item_sk
    and d.d_month_seq = (select distinct d_month_seq from date_dim
                         where d_year = 2001 and d_moy = 1)
    and i.i_current_price > 1.2 * (select avg(j.i_current_price)
                                   from item j
                                   where j.i_category = i.i_category)
group by a.ca_state
having count(*) >= 10
order by cnt, a.ca_state
limit 100
""",
    9: """
select case when (select count(*) from store_sales
                  where ss_quantity between 1 and 20) > 25437
            then (select avg(ss_ext_discount_amt) from store_sales
                  where ss_quantity between 1 and 20)
            else (select avg(ss_net_paid) from store_sales
                  where ss_quantity between 1 and 20) end bucket1,
       case when (select count(*) from store_sales
                  where ss_quantity between 21 and 40) > 22746
            then (select avg(ss_ext_discount_amt) from store_sales
                  where ss_quantity between 21 and 40)
            else (select avg(ss_net_paid) from store_sales
                  where ss_quantity between 21 and 40) end bucket2,
       case when (select count(*) from store_sales
                  where ss_quantity between 41 and 60) > 9387
            then (select avg(ss_ext_discount_amt) from store_sales
                  where ss_quantity between 41 and 60)
            else (select avg(ss_net_paid) from store_sales
                  where ss_quantity between 41 and 60) end bucket3,
       case when (select count(*) from store_sales
                  where ss_quantity between 61 and 80) > 10098
            then (select avg(ss_ext_discount_amt) from store_sales
                  where ss_quantity between 61 and 80)
            else (select avg(ss_net_paid) from store_sales
                  where ss_quantity between 61 and 80) end bucket4,
       case when (select count(*) from store_sales
                  where ss_quantity between 81 and 100) > 18213
            then (select avg(ss_ext_discount_amt) from store_sales
                  where ss_quantity between 81 and 100)
            else (select avg(ss_net_paid) from store_sales
                  where ss_quantity between 81 and 100) end bucket5
from reason
where r_reason_sk = 1
""",
    32: """
select sum(cs_ext_discount_amt) as "excess discount amount"
from catalog_sales, item, date_dim
where i_manufact_id = 77
    and i_item_sk = cs_item_sk
    and d_date between '2000-01-27'
        and (cast('2000-01-27' as date) + interval '90' day)
    and d_date_sk = cs_sold_date_sk
    and cs_ext_discount_amt > (
        select 1.3 * avg(cs_ext_discount_amt)
        from catalog_sales, date_dim
        where cs_item_sk = i_item_sk
            and d_date between '2000-01-27'
                and (cast('2000-01-27' as date) + interval '90' day)
            and d_date_sk = cs_sold_date_sk)
limit 100
""",
    60: """
with ss as (
    select i_item_id, sum(ss_ext_sales_price) total_sales
    from store_sales, date_dim, customer_address, item
    where i_item_id in (select i_item_id from item
                        where i_category in ('Children'))
        and ss_item_sk = i_item_sk
        and ss_sold_date_sk = d_date_sk
        and d_year = 2000 and d_moy = 9
        and ss_addr_sk = ca_address_sk
        and ca_gmt_offset = -5
    group by i_item_id),
cs as (
    select i_item_id, sum(cs_ext_sales_price) total_sales
    from catalog_sales, date_dim, customer_address, item
    where i_item_id in (select i_item_id from item
                        where i_category in ('Children'))
        and cs_item_sk = i_item_sk
        and cs_sold_date_sk = d_date_sk
        and d_year = 2000 and d_moy = 9
        and cs_addr_sk = ca_address_sk
        and ca_gmt_offset = -5
    group by i_item_id),
ws as (
    select i_item_id, sum(ws_ext_sales_price) total_sales
    from web_sales, date_dim, customer_address, item
    where i_item_id in (select i_item_id from item
                        where i_category in ('Children'))
        and ws_item_sk = i_item_sk
        and ws_sold_date_sk = d_date_sk
        and d_year = 2000 and d_moy = 9
        and ws_addr_sk = ca_address_sk
        and ca_gmt_offset = -5
    group by i_item_id)
select i_item_id, sum(total_sales) total_sales
from (select * from ss union all select * from cs
      union all select * from ws) tmp1
group by i_item_id
order by i_item_id, total_sales
limit 100
""",
    61: """
select promotions, total,
    cast(promotions as decimal) / cast(total as decimal) * 100 as ratio
from (select sum(ss_ext_sales_price) promotions
      from store_sales, store, promotion, date_dim, customer,
          customer_address, item
      where ss_sold_date_sk = d_date_sk
          and ss_store_sk = s_store_sk
          and ss_promo_sk = p_promo_sk
          and ss_customer_sk = c_customer_sk
          and ca_address_sk = c_current_addr_sk
          and ss_item_sk = i_item_sk
          and ca_gmt_offset = -5
          and i_category = 'Jewelry'
          and (p_channel_email = 'Y' or p_channel_event = 'Y')
          and s_gmt_offset = -5
          and d_year = 1998 and d_moy = 11) promotional_sales,
    (select sum(ss_ext_sales_price) total
     from store_sales, store, date_dim, customer, customer_address,
         item
     where ss_sold_date_sk = d_date_sk
         and ss_store_sk = s_store_sk
         and ss_customer_sk = c_customer_sk
         and ca_address_sk = c_current_addr_sk
         and ss_item_sk = i_item_sk
         and ca_gmt_offset = -5
         and i_category = 'Jewelry'
         and s_gmt_offset = -5
         and d_year = 1998 and d_moy = 11) all_sales
order by promotions, total
limit 100
""",
    63: """
select manager_id, sum_sales, avg_monthly_sales
from (select i_manager_id manager_id,
          sum(ss_sales_price) sum_sales,
          avg(sum(ss_sales_price)) over (partition by i_manager_id)
              avg_monthly_sales
      from item, store_sales, date_dim, store
      where ss_item_sk = i_item_sk
          and ss_sold_date_sk = d_date_sk
          and ss_store_sk = s_store_sk
          and d_month_seq in (24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
                              34, 35)
          and i_category in ('Books', 'Children', 'Electronics')
      group by i_manager_id, d_moy) tmp1
where case when avg_monthly_sales > 0
          then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
          else null end > 0.1
order by manager_id, avg_monthly_sales, sum_sales
limit 100
""",
    68: """
select c_last_name, c_first_name, ca_city, bought_city,
    ss_ticket_number, extended_price, extended_tax, list_price
from (select ss_ticket_number, ss_customer_sk, ca_city bought_city,
          sum(ss_ext_sales_price) extended_price,
          sum(ss_ext_list_price) list_price,
          sum(ss_coupon_amt) extended_tax
      from store_sales, date_dim, store, household_demographics,
          customer_address
      where store_sales.ss_sold_date_sk = date_dim.d_date_sk
          and store_sales.ss_store_sk = store.s_store_sk
          and store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
          and store_sales.ss_addr_sk = customer_address.ca_address_sk
          and date_dim.d_dom between 1 and 2
          and (household_demographics.hd_dep_count = 4
               or household_demographics.hd_vehicle_count = 3)
          and date_dim.d_year in (1999, 2000, 2001)
          and store.s_city in ('city1', 'city2')
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk, ca_city)
    dn, customer, customer_address current_addr
where ss_customer_sk = c_customer_sk
    and customer.c_current_addr_sk = current_addr.ca_address_sk
    and current_addr.ca_city <> bought_city
order by c_last_name, ss_ticket_number
limit 100
""",
    88: """
select *
from (select count(*) h8_30_to_9
      from store_sales, household_demographics, time_dim, store
      where ss_sold_time_sk = time_dim.t_time_sk
          and ss_hdemo_sk = household_demographics.hd_demo_sk
          and ss_store_sk = s_store_sk
          and time_dim.t_hour = 8 and time_dim.t_minute >= 30
          and ((household_demographics.hd_dep_count = 4
                and household_demographics.hd_vehicle_count <= 6)
               or (household_demographics.hd_dep_count = 2
                   and household_demographics.hd_vehicle_count <= 4)
               or (household_demographics.hd_dep_count = 0
                   and household_demographics.hd_vehicle_count <= 2))
          and store.s_store_name = 'store a') s1,
    (select count(*) h9_to_9_30
     from store_sales, household_demographics, time_dim, store
     where ss_sold_time_sk = time_dim.t_time_sk
         and ss_hdemo_sk = household_demographics.hd_demo_sk
         and ss_store_sk = s_store_sk
         and time_dim.t_hour = 9 and time_dim.t_minute < 30
         and ((household_demographics.hd_dep_count = 4
               and household_demographics.hd_vehicle_count <= 6)
              or (household_demographics.hd_dep_count = 2
                  and household_demographics.hd_vehicle_count <= 4)
              or (household_demographics.hd_dep_count = 0
                  and household_demographics.hd_vehicle_count <= 2))
         and store.s_store_name = 'store a') s2,
    (select count(*) h9_30_to_10
     from store_sales, household_demographics, time_dim, store
     where ss_sold_time_sk = time_dim.t_time_sk
         and ss_hdemo_sk = household_demographics.hd_demo_sk
         and ss_store_sk = s_store_sk
         and time_dim.t_hour = 9 and time_dim.t_minute >= 30
         and ((household_demographics.hd_dep_count = 4
               and household_demographics.hd_vehicle_count <= 6)
              or (household_demographics.hd_dep_count = 2
                  and household_demographics.hd_vehicle_count <= 4)
              or (household_demographics.hd_dep_count = 0
                  and household_demographics.hd_vehicle_count <= 2))
         and store.s_store_name = 'store a') s3,
    (select count(*) h10_to_10_30
     from store_sales, household_demographics, time_dim, store
     where ss_sold_time_sk = time_dim.t_time_sk
         and ss_hdemo_sk = household_demographics.hd_demo_sk
         and ss_store_sk = s_store_sk
         and time_dim.t_hour = 10 and time_dim.t_minute < 30
         and ((household_demographics.hd_dep_count = 4
               and household_demographics.hd_vehicle_count <= 6)
              or (household_demographics.hd_dep_count = 2
                  and household_demographics.hd_vehicle_count <= 4)
              or (household_demographics.hd_dep_count = 0
                  and household_demographics.hd_vehicle_count <= 2))
         and store.s_store_name = 'store a') s4
""",
    89: """
select *
from (select i_category, i_class, i_brand, s_store_name, s_company_name,
          d_moy, sum(ss_sales_price) sum_sales,
          avg(sum(ss_sales_price)) over (partition by i_category,
              i_brand, s_store_name, s_company_name) avg_monthly_sales
      from item, store_sales, date_dim, store
      where ss_item_sk = i_item_sk
          and ss_sold_date_sk = d_date_sk
          and ss_store_sk = s_store_sk
          and d_year in (1999)
          and ((i_category in ('Books', 'Electronics', 'Sports')
                and i_class in ('bookclass1', 'elecclass2', 'sporclass3'))
               or (i_category in ('Men', 'Jewelry', 'Women')
                   and i_class in ('menclass1', 'jeweclass2',
                                   'womeclass3')))
      group by i_category, i_class, i_brand, s_store_name,
          s_company_name, d_moy) tmp1
where case when avg_monthly_sales <> 0
          then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
          else null end > 0.1
order by sum_sales - avg_monthly_sales, s_store_name
limit 100
""",
    92: """
select sum(ws_ext_discount_amt) as "excess discount amount"
from web_sales, item, date_dim
where i_manufact_id = 350
    and i_item_sk = ws_item_sk
    and d_date between '2000-01-27'
        and (cast('2000-01-27' as date) + interval '90' day)
    and d_date_sk = ws_sold_date_sk
    and ws_ext_discount_amt > (
        select 1.3 * avg(ws_ext_discount_amt)
        from web_sales, date_dim
        where ws_item_sk = i_item_sk
            and d_date between '2000-01-27'
                and (cast('2000-01-27' as date) + interval '90' day)
            and d_date_sk = ws_sold_date_sk)
order by sum(ws_ext_discount_amt)
limit 100
""",
    17: """
select i_item_id, i_item_desc, s_state,
    count(ss_quantity) as store_sales_quantitycount,
    avg(ss_quantity) as store_sales_quantityave,
    stddev(ss_quantity) as store_sales_quantitystdev,
    stddev(ss_quantity) / avg(ss_quantity) as store_sales_quantitycov,
    count(sr_return_quantity) as store_returns_quantitycount,
    avg(sr_return_quantity) as store_returns_quantityave,
    stddev(sr_return_quantity) as store_returns_quantitystdev,
    stddev(sr_return_quantity) / avg(sr_return_quantity)
        as store_returns_quantitycov,
    count(cs_quantity) as catalog_sales_quantitycount,
    avg(cs_quantity) as catalog_sales_quantityave,
    stddev(cs_quantity) / avg(cs_quantity) as catalog_sales_quantitycov
from store_sales, store_returns, catalog_sales, date_dim d1,
    date_dim d2, date_dim d3, store, item
where d1.d_qoy = 1 and d1.d_year = 2001
    and d1.d_date_sk = ss_sold_date_sk
    and i_item_sk = ss_item_sk
    and s_store_sk = ss_store_sk
    and ss_customer_sk = sr_customer_sk
    and ss_item_sk = sr_item_sk
    and ss_ticket_number = sr_ticket_number
    and sr_returned_date_sk = d2.d_date_sk
    and d2.d_qoy between 1 and 3 and d2.d_year = 2001
    and sr_customer_sk = cs_customer_sk
    and sr_item_sk = cs_item_sk
    and cs_sold_date_sk = d3.d_date_sk
    and d3.d_qoy between 1 and 3 and d3.d_year = 2001
group by i_item_id, i_item_desc, s_state
order by i_item_id, i_item_desc, s_state
limit 100
""",
    69: """
select cd_gender, cd_marital_status, cd_education_status,
    count(*) cnt1, cd_credit_rating, count(*) cnt2
from customer c, customer_address ca, customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
    and ca_state in ('KY', 'GA', 'NM')
    and cd_demo_sk = c.c_current_cdemo_sk
    and exists (select * from store_sales, date_dim
                where c.c_customer_sk = ss_customer_sk
                    and ss_sold_date_sk = d_date_sk
                    and d_year = 2001 and d_moy between 4 and 6)
    and not exists (select * from web_sales, date_dim
                    where c.c_customer_sk = ws_customer_sk
                        and ws_sold_date_sk = d_date_sk
                        and d_year = 2001 and d_moy between 4 and 6)
group by cd_gender, cd_marital_status, cd_education_status,
    cd_credit_rating
order by cd_gender, cd_marital_status, cd_education_status,
    cd_credit_rating
limit 100
""",
    70: """
select sum(ss_net_profit) as total_sum, s_state, s_county,
    grouping(s_state) + grouping(s_county) as lochierarchy,
    rank() over (partition by grouping(s_state) + grouping(s_county),
        case when grouping(s_county) = 0 then s_state end
        order by sum(ss_net_profit) desc) as rank_within_parent
from store_sales, date_dim d1, store
where d1.d_month_seq between 24 and 35
    and d1.d_date_sk = ss_sold_date_sk
    and s_store_sk = ss_store_sk
group by rollup(s_state, s_county)
order by lochierarchy desc,
    case when lochierarchy = 0 then s_state end nulls first,
    rank_within_parent
limit 100
""",
    76: """
select channel, col_name, d_year, d_qoy, i_category,
    count(*) sales_cnt, sum(ext_sales_price) sales_amt
from (
    select 'store' as channel, 'ss_sold_time_sk' col_name, d_year, d_qoy,
        i_category, ss_ext_sales_price ext_sales_price
    from store_sales, item, date_dim
    where ss_sold_time_sk is null
        and ss_sold_date_sk = d_date_sk
        and ss_item_sk = i_item_sk
    union all
    select 'web' as channel, 'ws_ship_customer_sk' col_name, d_year, d_qoy,
        i_category, ws_ext_sales_price ext_sales_price
    from web_sales, item, date_dim
    where ws_ship_customer_sk is null
        and ws_sold_date_sk = d_date_sk
        and ws_item_sk = i_item_sk
    union all
    select 'catalog' as channel, 'cs_ship_addr_sk' col_name, d_year, d_qoy,
        i_category, cs_ext_sales_price ext_sales_price
    from catalog_sales, item, date_dim
    where cs_ship_addr_sk is null
        and cs_sold_date_sk = d_date_sk
        and cs_item_sk = i_item_sk) foo
group by channel, col_name, d_year, d_qoy, i_category
order by channel, col_name, d_year, d_qoy, i_category
limit 100
""",
    87: """
select count(*) from (
    select distinct c_last_name, c_first_name, d_date
    from store_sales, date_dim, customer
    where store_sales.ss_sold_date_sk = date_dim.d_date_sk
        and store_sales.ss_customer_sk = customer.c_customer_sk
        and d_month_seq between 24 and 35
    except
    select distinct c_last_name, c_first_name, d_date
    from catalog_sales, date_dim, customer
    where catalog_sales.cs_sold_date_sk = date_dim.d_date_sk
        and catalog_sales.cs_customer_sk = customer.c_customer_sk
        and d_month_seq between 24 and 35
    except
    select distinct c_last_name, c_first_name, d_date
    from web_sales, date_dim, customer
    where web_sales.ws_sold_date_sk = date_dim.d_date_sk
        and web_sales.ws_customer_sk = customer.c_customer_sk
        and d_month_seq between 24 and 35
) cool_cust
""",
    58: """
with ss_items as (
    select i_item_id ss_it, sum(ss_ext_sales_price) ss_item_rev
    from store_sales, item, date_dim
    where ss_item_sk = i_item_sk
        and d_date between '2001-06-01' and
            (cast('2001-06-01' as date) + interval '14' day)
        and d_date_sk = ss_sold_date_sk
    group by i_item_id),
cs_items as (
    select i_item_id cs_it, sum(cs_ext_sales_price) cs_item_rev
    from catalog_sales, item, date_dim
    where cs_item_sk = i_item_sk
        and d_date between '2001-06-01' and
            (cast('2001-06-01' as date) + interval '14' day)
        and d_date_sk = cs_sold_date_sk
    group by i_item_id),
ws_items as (
    select i_item_id ws_it, sum(ws_ext_sales_price) ws_item_rev
    from web_sales, item, date_dim
    where ws_item_sk = i_item_sk
        and d_date between '2001-06-01' and
            (cast('2001-06-01' as date) + interval '14' day)
        and d_date_sk = ws_sold_date_sk
    group by i_item_id)
select ss_it item_id, ss_item_rev,
    ss_item_rev / ((ss_item_rev + cs_item_rev + ws_item_rev) / 3) * 100
        ss_dev,
    cs_item_rev,
    cs_item_rev / ((ss_item_rev + cs_item_rev + ws_item_rev) / 3) * 100
        cs_dev,
    ws_item_rev,
    ws_item_rev / ((ss_item_rev + cs_item_rev + ws_item_rev) / 3) * 100
        ws_dev,
    (ss_item_rev + cs_item_rev + ws_item_rev) / 3 average
from ss_items, cs_items, ws_items
where ss_it = cs_it
    and ss_it = ws_it
    and ss_item_rev between 0.9 * cs_item_rev and 1.1 * cs_item_rev
    and ss_item_rev between 0.9 * ws_item_rev and 1.1 * ws_item_rev
    and cs_item_rev between 0.9 * ss_item_rev and 1.1 * ss_item_rev
    and cs_item_rev between 0.9 * ws_item_rev and 1.1 * ws_item_rev
    and ws_item_rev between 0.9 * ss_item_rev and 1.1 * ss_item_rev
    and ws_item_rev between 0.9 * cs_item_rev and 1.1 * cs_item_rev
order by item_id, ss_item_rev
limit 100
""",
    16: """
select count(distinct cs_order_number) as "order count",
    sum(cs_ext_sales_price) as "total shipping cost",
    sum(cs_net_profit) as "total net profit"
from catalog_sales cs1, date_dim, customer_address, call_center
where d_date between '2000-02-01' and
        (cast('2000-02-01' as date) + interval '60' day)
    and cs1.cs_ship_date_sk = d_date_sk
    and cs1.cs_ship_addr_sk = ca_address_sk
    and ca_state = 'GA'
    and cs1.cs_call_center_sk = cc_call_center_sk
    and cc_county in ('Ziebach County', 'Walker County',
                      'Williamson County')
    and exists (select * from catalog_sales cs2
                where cs1.cs_order_number = cs2.cs_order_number
                    and cs1.cs_warehouse_sk <> cs2.cs_warehouse_sk)
    and not exists (select * from catalog_returns cr1
                    where cs1.cs_order_number = cr1.cr_order_number)
order by count(distinct cs_order_number)
limit 100
""",
    21: """
select *
from (select w_warehouse_name, i_item_id,
          sum(case when cast(d_date as date) <
                  cast('2000-03-11' as date)
              then inv_quantity_on_hand else 0 end) as inv_before,
          sum(case when cast(d_date as date) >=
                  cast('2000-03-11' as date)
              then inv_quantity_on_hand else 0 end) as inv_after
      from inventory, warehouse, item, date_dim
      where i_current_price between 0.99 and 1.49
          and i_item_sk = inv_item_sk
          and inv_warehouse_sk = w_warehouse_sk
          and inv_date_sk = d_date_sk
          and d_date between (cast('2000-03-11' as date)
                              - interval '30' day)
              and (cast('2000-03-11' as date) + interval '30' day)
      group by w_warehouse_name, i_item_id) x
where (case when inv_before > 0 then
           cast(inv_after as decimal) / cast(inv_before as decimal)
       else null end) between 2.0 / 3.0 and 3.0 / 2.0
order by w_warehouse_name, i_item_id
limit 100
""",
    30: """
with customer_total_return as (
    select wr_returning_customer_sk as ctr_customer_sk,
        ca_state as ctr_state,
        sum(wr_return_amt) as ctr_total_return
    from web_returns, date_dim, customer_address
    where wr_returned_date_sk = d_date_sk
        and d_year = 2000
        and wr_returning_addr_sk = ca_address_sk
    group by wr_returning_customer_sk, ca_state)
select c_customer_id, c_salutation, c_first_name, c_last_name,
    c_preferred_cust_flag, c_birth_month, c_birth_year,
    c_birth_country, ctr_total_return
from customer_total_return ctr1, customer_address, customer
where ctr1.ctr_total_return > (
        select avg(ctr_total_return) * 1.2
        from customer_total_return ctr2
        where ctr1.ctr_state = ctr2.ctr_state)
    and ca_address_sk = c_current_addr_sk
    and ca_state = 'GA'
    and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id, c_salutation, c_first_name, c_last_name,
    c_preferred_cust_flag, c_birth_month, c_birth_year,
    c_birth_country, ctr_total_return
limit 100
""",
    39: """
with inv as (
    select w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy, stdev,
        mean, case mean when 0 then null else stdev / mean end cov
    from (select w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy,
              stddev(inv_quantity_on_hand) stdev,
              avg(inv_quantity_on_hand) mean
          from inventory, item, warehouse, date_dim
          where inv_item_sk = i_item_sk
              and inv_warehouse_sk = w_warehouse_sk
              and inv_date_sk = d_date_sk
              and d_year = 2000
          group by w_warehouse_name, w_warehouse_sk, i_item_sk,
              d_moy) foo
    where case mean when 0 then 0 else stdev / mean end > 1)
select inv1.w_warehouse_sk wsk1, inv1.i_item_sk isk1, inv1.d_moy moy1,
    inv1.mean mean1, inv1.cov cov1,
    inv2.w_warehouse_sk wsk2, inv2.i_item_sk isk2, inv2.d_moy moy2,
    inv2.mean mean2, inv2.cov cov2
from inv inv1, inv inv2
where inv1.i_item_sk = inv2.i_item_sk
    and inv1.w_warehouse_sk = inv2.w_warehouse_sk
    and inv1.d_moy = 1
    and inv2.d_moy = 2
order by wsk1, isk1, moy1, mean1, cov1
limit 100
""",
    40: """
select w_state, i_item_id,
    sum(case when cast(d_date as date) < cast('2000-03-11' as date)
        then cs_sales_price - coalesce(cr_return_amount, 0)
        else 0 end) as sales_before,
    sum(case when cast(d_date as date) >= cast('2000-03-11' as date)
        then cs_sales_price - coalesce(cr_return_amount, 0)
        else 0 end) as sales_after
from catalog_sales
    left outer join catalog_returns
        on (cs_order_number = cr_order_number
            and cs_item_sk = cr_item_sk),
    warehouse, item, date_dim
where i_current_price between 0.99 and 1.49
    and i_item_sk = cs_item_sk
    and cs_warehouse_sk = w_warehouse_sk
    and cs_sold_date_sk = d_date_sk
    and d_date between (cast('2000-03-11' as date) - interval '30' day)
        and (cast('2000-03-11' as date) + interval '30' day)
group by w_state, i_item_id
order by w_state, i_item_id
limit 100
""",
    62: """
select substr(w_warehouse_name, 1, 20) wname, sm_type, web_name,
    sum(case when (ws_ship_date_sk - ws_sold_date_sk <= 30)
        then 1 else 0 end) as "30 days",
    sum(case when (ws_ship_date_sk - ws_sold_date_sk > 30)
        and (ws_ship_date_sk - ws_sold_date_sk <= 60)
        then 1 else 0 end) as "31-60 days",
    sum(case when (ws_ship_date_sk - ws_sold_date_sk > 60)
        and (ws_ship_date_sk - ws_sold_date_sk <= 90)
        then 1 else 0 end) as "61-90 days",
    sum(case when (ws_ship_date_sk - ws_sold_date_sk > 90)
        and (ws_ship_date_sk - ws_sold_date_sk <= 120)
        then 1 else 0 end) as "91-120 days",
    sum(case when (ws_ship_date_sk - ws_sold_date_sk > 120)
        then 1 else 0 end) as ">120 days"
from web_sales, warehouse, ship_mode, web_site, date_dim
where d_month_seq between 24 and 35
    and ws_ship_date_sk = d_date_sk
    and ws_warehouse_sk = w_warehouse_sk
    and ws_ship_mode_sk = sm_ship_mode_sk
    and ws_web_site_sk = web_site_sk
group by substr(w_warehouse_name, 1, 20), sm_type, web_name
order by wname, sm_type, web_name
limit 100
""",
    85: """
select substr(r_reason_desc, 1, 20) rdesc, avg(ws_quantity) aq,
    avg(wr_refunded_cash) arc, avg(wr_fee) af
from web_sales, web_returns, web_page, customer_demographics cd1,
    customer_demographics cd2, customer_address, date_dim, reason
where ws_web_page_sk = wp_web_page_sk
    and ws_item_sk = wr_item_sk
    and ws_order_number = wr_order_number
    and ws_sold_date_sk = d_date_sk and d_year = 2000
    and cd1.cd_demo_sk = wr_refunded_cdemo_sk
    and ca_address_sk = wr_refunded_addr_sk
    and r_reason_sk = wr_reason_sk
    and cd2.cd_demo_sk = cd1.cd_demo_sk
    and ((cd1.cd_marital_status = 'M'
          and cd1.cd_education_status = 'Advanced Degree'
          and ws_sales_price between 100.00 and 150.00)
         or (cd1.cd_marital_status = 'S'
             and cd1.cd_education_status = 'College'
             and ws_sales_price between 50.00 and 100.00)
         or (cd1.cd_marital_status = 'W'
             and cd1.cd_education_status = '2 yr Degree'
             and ws_sales_price between 150.00 and 200.00))
    and ((ca_country = 'United States'
          and ca_state in ('IN', 'OH', 'NJ')
          and ws_net_profit between 100 and 200)
         or (ca_country = 'United States'
             and ca_state in ('WI', 'CT', 'KY')
             and ws_net_profit between 150 and 300)
         or (ca_country = 'United States'
             and ca_state in ('LA', 'IA', 'AR')
             and ws_net_profit between 50 and 250))
group by r_reason_desc
order by rdesc, aq, arc, af
limit 100
""",
    91: """
select cc_call_center_id call_center, cc_name call_center_name,
    cc_manager manager, sum(cr_net_loss) returns_loss
from call_center, catalog_returns, date_dim, customer,
    customer_address, customer_demographics, household_demographics
where cr_call_center_sk = cc_call_center_sk
    and cr_returned_date_sk = d_date_sk
    and cr_returning_customer_sk = c_customer_sk
    and cd_demo_sk = c_current_cdemo_sk
    and hd_demo_sk = c_current_hdemo_sk
    and ca_address_sk = c_current_addr_sk
    and d_year = 1998 and d_moy = 11
    and ((cd_marital_status = 'M'
          and cd_education_status = 'Unknown')
         or (cd_marital_status = 'W'
             and cd_education_status = 'Advanced Degree'))
    and hd_buy_potential like '0-500%'
    and ca_gmt_offset = -7
group by cc_call_center_id, cc_name, cc_manager, cd_marital_status,
    cd_education_status
order by returns_loss desc
""",
    94: """
select count(distinct ws_order_number) as "order count",
    sum(ws_ext_sales_price) as "total shipping cost",
    sum(ws_net_profit) as "total net profit"
from web_sales ws1, date_dim, customer_address, web_site
where d_date between '2001-02-01' and
        (cast('2001-02-01' as date) + interval '60' day)
    and ws1.ws_ship_date_sk = d_date_sk
    and ws1.ws_ship_addr_sk = ca_address_sk
    and ca_state = 'IL'
    and ws1.ws_web_site_sk = web_site_sk
    and web_company_name = 'pri'
    and exists (select * from web_sales ws2
                where ws1.ws_order_number = ws2.ws_order_number
                    and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
    and not exists (select * from web_returns wr1
                    where ws1.ws_order_number = wr1.wr_order_number)
order by count(distinct ws_order_number)
limit 100
""",
    99: """
select substr(w_warehouse_name, 1, 20) wname, sm_type, cc_name,
    sum(case when (cs_ship_date_sk - cs_sold_date_sk <= 30)
        then 1 else 0 end) as "30 days",
    sum(case when (cs_ship_date_sk - cs_sold_date_sk > 30)
        and (cs_ship_date_sk - cs_sold_date_sk <= 60)
        then 1 else 0 end) as "31-60 days",
    sum(case when (cs_ship_date_sk - cs_sold_date_sk > 60)
        and (cs_ship_date_sk - cs_sold_date_sk <= 90)
        then 1 else 0 end) as "61-90 days",
    sum(case when (cs_ship_date_sk - cs_sold_date_sk > 90)
        and (cs_ship_date_sk - cs_sold_date_sk <= 120)
        then 1 else 0 end) as "91-120 days",
    sum(case when (cs_ship_date_sk - cs_sold_date_sk > 120)
        then 1 else 0 end) as ">120 days"
from catalog_sales, warehouse, ship_mode, call_center, date_dim
where d_month_seq between 24 and 35
    and cs_ship_date_sk = d_date_sk
    and cs_warehouse_sk = w_warehouse_sk
    and cs_ship_mode_sk = sm_ship_mode_sk
    and cs_call_center_sk = cc_call_center_sk
group by substr(w_warehouse_name, 1, 20), sm_type, cc_name
order by wname, sm_type, cc_name
limit 100
""",
    1: """
with customer_total_return as (
    select sr_customer_sk as ctr_customer_sk,
        sr_store_sk as ctr_store_sk,
        sum(sr_return_amt) as ctr_total_return
    from store_returns, date_dim
    where sr_returned_date_sk = d_date_sk and d_year = 2000
    group by sr_customer_sk, sr_store_sk)
select c_customer_id
from customer_total_return ctr1, store, customer
where ctr1.ctr_total_return > (
        select avg(ctr_total_return) * 1.2
        from customer_total_return ctr2
        where ctr1.ctr_store_sk = ctr2.ctr_store_sk)
    and s_store_sk = ctr1.ctr_store_sk
    and s_state = 'AL'
    and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id
limit 100
""",
    11: """
with year_total as (
    select c_customer_id customer_id, c_first_name customer_first_name,
        c_last_name customer_last_name, d_year as dyear,
        sum(ss_ext_list_price - ss_ext_discount_amt) year_total,
        's' sale_type
    from customer, store_sales, date_dim
    where c_customer_sk = ss_customer_sk
        and ss_sold_date_sk = d_date_sk
    group by c_customer_id, c_first_name, c_last_name, d_year
    union all
    select c_customer_id customer_id, c_first_name customer_first_name,
        c_last_name customer_last_name, d_year as dyear,
        sum(ws_ext_list_price - ws_ext_discount_amt) year_total,
        'w' sale_type
    from customer, web_sales, date_dim
    where c_customer_sk = ws_customer_sk
        and ws_sold_date_sk = d_date_sk
    group by c_customer_id, c_first_name, c_last_name, d_year)
select t_s_secyear.customer_id, t_s_secyear.customer_first_name,
    t_s_secyear.customer_last_name
from year_total t_s_firstyear, year_total t_s_secyear,
    year_total t_w_firstyear, year_total t_w_secyear
where t_s_secyear.customer_id = t_s_firstyear.customer_id
    and t_s_firstyear.customer_id = t_w_secyear.customer_id
    and t_s_firstyear.customer_id = t_w_firstyear.customer_id
    and t_s_firstyear.sale_type = 's'
    and t_w_firstyear.sale_type = 'w'
    and t_s_secyear.sale_type = 's'
    and t_w_secyear.sale_type = 'w'
    and t_s_firstyear.dyear = 2001
    and t_s_secyear.dyear = 2002
    and t_w_firstyear.dyear = 2001
    and t_w_secyear.dyear = 2002
    and t_s_firstyear.year_total > 0
    and t_w_firstyear.year_total > 0
    and case when t_w_firstyear.year_total > 0
        then t_w_secyear.year_total / t_w_firstyear.year_total
        else null end
      > case when t_s_firstyear.year_total > 0
        then t_s_secyear.year_total / t_s_firstyear.year_total
        else null end
order by t_s_secyear.customer_id, t_s_secyear.customer_first_name,
    t_s_secyear.customer_last_name
limit 100
""",
    31: """
with ss as (
    select ca_county, d_qoy, d_year, sum(ss_ext_sales_price)
        as store_sales
    from store_sales, date_dim, customer_address
    where ss_sold_date_sk = d_date_sk
        and ss_addr_sk = ca_address_sk
    group by ca_county, d_qoy, d_year),
ws as (
    select ca_county, d_qoy, d_year, sum(ws_ext_sales_price)
        as web_sales
    from web_sales, date_dim, customer_address
    where ws_sold_date_sk = d_date_sk
        and ws_addr_sk = ca_address_sk
    group by ca_county, d_qoy, d_year)
select ss1.ca_county, ss1.d_year,
    ws2.web_sales / ws1.web_sales web_q1_q2_increase,
    ss2.store_sales / ss1.store_sales store_q1_q2_increase,
    ws3.web_sales / ws2.web_sales web_q2_q3_increase,
    ss3.store_sales / ss2.store_sales store_q2_q3_increase
from ss ss1, ss ss2, ss ss3, ws ws1, ws ws2, ws ws3
where ss1.d_qoy = 1 and ss1.d_year = 2000
    and ss1.ca_county = ss2.ca_county
    and ss2.d_qoy = 2 and ss2.d_year = 2000
    and ss2.ca_county = ss3.ca_county
    and ss3.d_qoy = 3 and ss3.d_year = 2000
    and ss1.ca_county = ws1.ca_county
    and ws1.d_qoy = 1 and ws1.d_year = 2000
    and ws1.ca_county = ws2.ca_county
    and ws2.d_qoy = 2 and ws2.d_year = 2000
    and ws1.ca_county = ws3.ca_county
    and ws3.d_qoy = 3 and ws3.d_year = 2000
    and case when ws1.web_sales > 0
        then ws2.web_sales / ws1.web_sales else null end
      > case when ss1.store_sales > 0
        then ss2.store_sales / ss1.store_sales else null end
    and case when ws2.web_sales > 0
        then ws3.web_sales / ws2.web_sales else null end
      > case when ss2.store_sales > 0
        then ss3.store_sales / ss2.store_sales else null end
order by ss1.ca_county
""",
    35: """
select ca_state, cd_gender, cd_marital_status, cd_dep_count,
    count(*) cnt1, avg(cd_dep_count) a1, max(cd_dep_count) m1,
    sum(cd_dep_count) s1
from customer c, customer_address ca, customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
    and cd_demo_sk = c.c_current_cdemo_sk
    and exists (select * from store_sales, date_dim
                where c.c_customer_sk = ss_customer_sk
                    and ss_sold_date_sk = d_date_sk
                    and d_year = 2002 and d_qoy < 4)
    and (exists (select * from web_sales, date_dim
                 where c.c_customer_sk = ws_customer_sk
                     and ws_sold_date_sk = d_date_sk
                     and d_year = 2002 and d_qoy < 4)
         or exists (select * from catalog_sales, date_dim
                    where c.c_customer_sk = cs_customer_sk
                        and cs_sold_date_sk = d_date_sk
                        and d_year = 2002 and d_qoy < 4))
group by ca_state, cd_gender, cd_marital_status, cd_dep_count
order by ca_state, cd_gender, cd_marital_status, cd_dep_count
limit 100
""",
    81: """
with customer_total_return as (
    select cr_returning_customer_sk as ctr_customer_sk,
        ca_state as ctr_state,
        sum(cr_return_amount) as ctr_total_return
    from catalog_returns, date_dim, customer_address
    where cr_returned_date_sk = d_date_sk
        and d_year = 2000
        and cr_returning_addr_sk = ca_address_sk
    group by cr_returning_customer_sk, ca_state)
select c_customer_id, c_salutation, c_first_name, c_last_name,
    ca_state, ctr_total_return
from customer_total_return ctr1, customer_address, customer
where ctr1.ctr_total_return > (
        select avg(ctr_total_return) * 1.2
        from customer_total_return ctr2
        where ctr1.ctr_state = ctr2.ctr_state)
    and ca_address_sk = c_current_addr_sk
    and ca_state = 'GA'
    and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id, c_salutation, c_first_name, c_last_name,
    ca_state, ctr_total_return
limit 100
""",
    83: """
with sr_items as (
    select i_item_id item_id, sum(sr_return_quantity) sr_item_qty
    from store_returns, item, date_dim
    where sr_item_sk = i_item_sk
        and d_date in (select d_date from date_dim
                       where d_week_seq in
                           (select d_week_seq from date_dim
                            where d_date in ('2000-06-30', '2000-09-27',
                                             '2000-11-17')))
        and sr_returned_date_sk = d_date_sk
    group by i_item_id),
cr_items as (
    select i_item_id item_id, sum(cr_return_quantity) cr_item_qty
    from catalog_returns, item, date_dim
    where cr_item_sk = i_item_sk
        and d_date in (select d_date from date_dim
                       where d_week_seq in
                           (select d_week_seq from date_dim
                            where d_date in ('2000-06-30', '2000-09-27',
                                             '2000-11-17')))
        and cr_returned_date_sk = d_date_sk
    group by i_item_id),
wr_items as (
    select i_item_id item_id, sum(wr_return_quantity) wr_item_qty
    from web_returns, item, date_dim
    where wr_item_sk = i_item_sk
        and d_date in (select d_date from date_dim
                       where d_week_seq in
                           (select d_week_seq from date_dim
                            where d_date in ('2000-06-30', '2000-09-27',
                                             '2000-11-17')))
        and wr_returned_date_sk = d_date_sk
    group by i_item_id)
select sr_items.item_id, sr_item_qty,
    sr_item_qty / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 * 100
        sr_dev,
    cr_item_qty,
    cr_item_qty / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 * 100
        cr_dev,
    wr_item_qty,
    wr_item_qty / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 * 100
        wr_dev,
    (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 average
from sr_items, cr_items, wr_items
where sr_items.item_id = cr_items.item_id
    and sr_items.item_id = wr_items.item_id
order by sr_items.item_id, sr_item_qty
limit 100
""",
    84: """
select c_customer_id as customer_id,
    c_last_name || ', ' || c_first_name as customername
from customer, customer_address, customer_demographics,
    household_demographics, income_band, store_returns
where ca_city = 'city42'
    and c_current_addr_sk = ca_address_sk
    and ib_lower_bound >= 38128
    and ib_upper_bound <= 88128
    and ib_income_band_sk = hd_income_band_sk
    and cd_demo_sk = c_current_cdemo_sk
    and hd_demo_sk = c_current_hdemo_sk
    and sr_cdemo_sk = cd_demo_sk
order by c_customer_id
limit 100
""",
    4: """
with year_total as (
    select c_customer_id customer_id, c_first_name customer_first_name,
        c_last_name customer_last_name, d_year as dyear,
        sum(((ss_ext_list_price - ss_ext_wholesale_cost
              - ss_ext_discount_amt) + ss_ext_sales_price) / 2)
            year_total,
        's' sale_type
    from customer, store_sales, date_dim
    where c_customer_sk = ss_customer_sk
        and ss_sold_date_sk = d_date_sk
    group by c_customer_id, c_first_name, c_last_name, d_year
    union all
    select c_customer_id customer_id, c_first_name customer_first_name,
        c_last_name customer_last_name, d_year as dyear,
        sum(((cs_ext_list_price - cs_ext_wholesale_cost
              - cs_ext_discount_amt) + cs_ext_sales_price) / 2)
            year_total,
        'c' sale_type
    from customer, catalog_sales, date_dim
    where c_customer_sk = cs_customer_sk
        and cs_sold_date_sk = d_date_sk
    group by c_customer_id, c_first_name, c_last_name, d_year
    union all
    select c_customer_id customer_id, c_first_name customer_first_name,
        c_last_name customer_last_name, d_year as dyear,
        sum(((ws_ext_list_price - ws_ext_wholesale_cost
              - ws_ext_discount_amt) + ws_ext_sales_price) / 2)
            year_total,
        'w' sale_type
    from customer, web_sales, date_dim
    where c_customer_sk = ws_customer_sk
        and ws_sold_date_sk = d_date_sk
    group by c_customer_id, c_first_name, c_last_name, d_year)
select t_s_secyear.customer_id, t_s_secyear.customer_first_name,
    t_s_secyear.customer_last_name
from year_total t_s_firstyear, year_total t_s_secyear,
    year_total t_c_firstyear, year_total t_c_secyear,
    year_total t_w_firstyear, year_total t_w_secyear
where t_s_secyear.customer_id = t_s_firstyear.customer_id
    and t_s_firstyear.customer_id = t_c_secyear.customer_id
    and t_s_firstyear.customer_id = t_c_firstyear.customer_id
    and t_s_firstyear.customer_id = t_w_firstyear.customer_id
    and t_s_firstyear.customer_id = t_w_secyear.customer_id
    and t_s_firstyear.sale_type = 's'
    and t_c_firstyear.sale_type = 'c'
    and t_w_firstyear.sale_type = 'w'
    and t_s_secyear.sale_type = 's'
    and t_c_secyear.sale_type = 'c'
    and t_w_secyear.sale_type = 'w'
    and t_s_firstyear.dyear = 2001
    and t_s_secyear.dyear = 2002
    and t_c_firstyear.dyear = 2001
    and t_c_secyear.dyear = 2002
    and t_w_firstyear.dyear = 2001
    and t_w_secyear.dyear = 2002
    and t_s_firstyear.year_total > 0
    and t_c_firstyear.year_total > 0
    and t_w_firstyear.year_total > 0
    and case when t_c_firstyear.year_total > 0
        then t_c_secyear.year_total / t_c_firstyear.year_total
        else null end
      > case when t_s_firstyear.year_total > 0
        then t_s_secyear.year_total / t_s_firstyear.year_total
        else null end
    and case when t_c_firstyear.year_total > 0
        then t_c_secyear.year_total / t_c_firstyear.year_total
        else null end
      > case when t_w_firstyear.year_total > 0
        then t_w_secyear.year_total / t_w_firstyear.year_total
        else null end
order by t_s_secyear.customer_id, t_s_secyear.customer_first_name,
    t_s_secyear.customer_last_name
limit 100
""",
    10: """
select cd_gender, cd_marital_status, cd_education_status,
    count(*) cnt1, cd_credit_rating, count(*) cnt2, cd_dep_count,
    count(*) cnt3
from customer c, customer_address ca, customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
    and ca_county in ('Ziebach County', 'Walker County',
                      'Williamson County', 'Franklin County',
                      'Fairfield County')
    and cd_demo_sk = c.c_current_cdemo_sk
    and exists (select * from store_sales, date_dim
                where c.c_customer_sk = ss_customer_sk
                    and ss_sold_date_sk = d_date_sk
                    and d_year = 2002 and d_moy between 1 and 4)
    and (exists (select * from web_sales, date_dim
                 where c.c_customer_sk = ws_customer_sk
                     and ws_sold_date_sk = d_date_sk
                     and d_year = 2002 and d_moy between 1 and 4)
         or exists (select * from catalog_sales, date_dim
                    where c.c_customer_sk = cs_customer_sk
                        and cs_sold_date_sk = d_date_sk
                        and d_year = 2002 and d_moy between 1 and 4))
group by cd_gender, cd_marital_status, cd_education_status,
    cd_credit_rating, cd_dep_count
order by cd_gender, cd_marital_status, cd_education_status,
    cd_credit_rating, cd_dep_count
limit 100
""",
    57: """
with v1 as (
    select i_category, i_brand, cc_name, d_year, d_moy,
        sum(cs_sales_price) sum_sales,
        avg(sum(cs_sales_price)) over (partition by i_category,
            i_brand, cc_name, d_year) avg_monthly_sales,
        rank() over (partition by i_category, i_brand, cc_name
            order by d_year, d_moy) rn
    from item, catalog_sales, date_dim, call_center
    where cs_item_sk = i_item_sk
        and cs_sold_date_sk = d_date_sk
        and cc_call_center_sk = cs_call_center_sk
        and (d_year = 2000
             or (d_year = 1999 and d_moy = 12)
             or (d_year = 2001 and d_moy = 1))
    group by i_category, i_brand, cc_name, d_year, d_moy),
v2 as (
    select v1.i_category i_category, v1.i_brand i_brand,
        v1.cc_name cc_name, v1.d_year d_year,
        v1.avg_monthly_sales avg_monthly_sales,
        v1.sum_sales sum_sales,
        v1_lag.sum_sales psum, v1_lead.sum_sales nsum
    from v1, v1 v1_lag, v1 v1_lead
    where v1.i_category = v1_lag.i_category
        and v1.i_category = v1_lead.i_category
        and v1.i_brand = v1_lag.i_brand
        and v1.i_brand = v1_lead.i_brand
        and v1.cc_name = v1_lag.cc_name
        and v1.cc_name = v1_lead.cc_name
        and v1.rn = v1_lag.rn + 1
        and v1.rn = v1_lead.rn - 1)
select *
from v2
where d_year = 2000
    and avg_monthly_sales > 0
    and case when avg_monthly_sales > 0
        then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
        else null end > 0.1
order by sum_sales - avg_monthly_sales, cc_name
limit 100
""",
    74: """
with year_total as (
    select c_customer_id customer_id, c_first_name customer_first_name,
        c_last_name customer_last_name, d_year as year1,
        sum(ss_net_paid) year_total, 's' sale_type
    from customer, store_sales, date_dim
    where c_customer_sk = ss_customer_sk
        and ss_sold_date_sk = d_date_sk
        and d_year in (2001, 2002)
    group by c_customer_id, c_first_name, c_last_name, d_year
    union all
    select c_customer_id customer_id, c_first_name customer_first_name,
        c_last_name customer_last_name, d_year as year1,
        sum(ws_net_paid) year_total, 'w' sale_type
    from customer, web_sales, date_dim
    where c_customer_sk = ws_customer_sk
        and ws_sold_date_sk = d_date_sk
        and d_year in (2001, 2002)
    group by c_customer_id, c_first_name, c_last_name, d_year)
select t_s_secyear.customer_id, t_s_secyear.customer_first_name,
    t_s_secyear.customer_last_name
from year_total t_s_firstyear, year_total t_s_secyear,
    year_total t_w_firstyear, year_total t_w_secyear
where t_s_secyear.customer_id = t_s_firstyear.customer_id
    and t_s_firstyear.customer_id = t_w_secyear.customer_id
    and t_s_firstyear.customer_id = t_w_firstyear.customer_id
    and t_s_firstyear.sale_type = 's'
    and t_w_firstyear.sale_type = 'w'
    and t_s_secyear.sale_type = 's'
    and t_w_secyear.sale_type = 'w'
    and t_s_firstyear.year1 = 2001
    and t_s_secyear.year1 = 2002
    and t_w_firstyear.year1 = 2001
    and t_w_secyear.year1 = 2002
    and t_s_firstyear.year_total > 0
    and t_w_firstyear.year_total > 0
    and case when t_w_firstyear.year_total > 0
        then t_w_secyear.year_total / t_w_firstyear.year_total
        else null end
      > case when t_s_firstyear.year_total > 0
        then t_s_secyear.year_total / t_s_firstyear.year_total
        else null end
order by t_s_secyear.customer_id, t_s_secyear.customer_first_name,
    t_s_secyear.customer_last_name
limit 100
""",
    2: """
with wscs as (
    select sold_date_sk, sales_price
    from (select ws_sold_date_sk sold_date_sk,
              ws_ext_sales_price sales_price
          from web_sales
          union all
          select cs_sold_date_sk sold_date_sk,
              cs_ext_sales_price sales_price
          from catalog_sales) sc),
wswscs as (
    select d_week_seq,
        sum(case when d_day_name = 'Sunday' then sales_price
            else null end) sun_sales,
        sum(case when d_day_name = 'Monday' then sales_price
            else null end) mon_sales,
        sum(case when d_day_name = 'Tuesday' then sales_price
            else null end) tue_sales,
        sum(case when d_day_name = 'Wednesday' then sales_price
            else null end) wed_sales,
        sum(case when d_day_name = 'Thursday' then sales_price
            else null end) thu_sales,
        sum(case when d_day_name = 'Friday' then sales_price
            else null end) fri_sales,
        sum(case when d_day_name = 'Saturday' then sales_price
            else null end) sat_sales
    from wscs, date_dim
    where d_date_sk = sold_date_sk
    group by d_week_seq)
select d_week_seq1, round(sun_sales1 / sun_sales2, 2) r1,
    round(mon_sales1 / mon_sales2, 2) r2,
    round(tue_sales1 / tue_sales2, 2) r3,
    round(wed_sales1 / wed_sales2, 2) r4,
    round(thu_sales1 / thu_sales2, 2) r5,
    round(fri_sales1 / fri_sales2, 2) r6,
    round(sat_sales1 / sat_sales2, 2) r7
from (select wswscs.d_week_seq d_week_seq1, sun_sales sun_sales1,
          mon_sales mon_sales1, tue_sales tue_sales1,
          wed_sales wed_sales1, thu_sales thu_sales1,
          fri_sales fri_sales1, sat_sales sat_sales1
      from wswscs, date_dim
      where date_dim.d_week_seq = wswscs.d_week_seq
          and d_year = 2001 and d_moy = 1 and d_dom = 1) y,
    (select wswscs.d_week_seq d_week_seq2, sun_sales sun_sales2,
         mon_sales mon_sales2, tue_sales tue_sales2,
         wed_sales wed_sales2, thu_sales thu_sales2,
         fri_sales fri_sales2, sat_sales sat_sales2
     from wswscs, date_dim
     where date_dim.d_week_seq = wswscs.d_week_seq
         and d_year = 2002 and d_moy = 1 and d_dom = 1) z
where d_week_seq1 = d_week_seq2 - 52
order by d_week_seq1
""",
    59: """
with wss as (
    select d_week_seq, ss_store_sk,
        sum(case when d_day_name = 'Sunday' then ss_sales_price
            else null end) sun_sales,
        sum(case when d_day_name = 'Monday' then ss_sales_price
            else null end) mon_sales,
        sum(case when d_day_name = 'Tuesday' then ss_sales_price
            else null end) tue_sales,
        sum(case when d_day_name = 'Wednesday' then ss_sales_price
            else null end) wed_sales,
        sum(case when d_day_name = 'Thursday' then ss_sales_price
            else null end) thu_sales,
        sum(case when d_day_name = 'Friday' then ss_sales_price
            else null end) fri_sales,
        sum(case when d_day_name = 'Saturday' then ss_sales_price
            else null end) sat_sales
    from store_sales, date_dim
    where d_date_sk = ss_sold_date_sk
    group by d_week_seq, ss_store_sk)
select s_store_name1, s_store_id1, d_week_seq1,
    sun_sales1 / sun_sales2 q1, mon_sales1 / mon_sales2 q2,
    tue_sales1 / tue_sales2 q3, wed_sales1 / wed_sales2 q4,
    thu_sales1 / thu_sales2 q5, fri_sales1 / fri_sales2 q6,
    sat_sales1 / sat_sales2 q7
from (select s_store_name s_store_name1, wss.d_week_seq d_week_seq1,
          s_store_id s_store_id1, sun_sales sun_sales1,
          mon_sales mon_sales1, tue_sales tue_sales1,
          wed_sales wed_sales1, thu_sales thu_sales1,
          fri_sales fri_sales1, sat_sales sat_sales1
      from wss, store, date_dim d
      where d.d_week_seq = wss.d_week_seq
          and ss_store_sk = s_store_sk
          and d_month_seq between 24 and 35) y,
    (select s_store_name s_store_name2, wss.d_week_seq d_week_seq2,
         s_store_id s_store_id2, sun_sales sun_sales2,
         mon_sales mon_sales2, tue_sales tue_sales2,
         wed_sales wed_sales2, thu_sales thu_sales2,
         fri_sales fri_sales2, sat_sales sat_sales2
     from wss, store, date_dim d
     where d.d_week_seq = wss.d_week_seq
         and ss_store_sk = s_store_sk
         and d_month_seq between 36 and 47) x
where s_store_id1 = s_store_id2
    and d_week_seq1 = d_week_seq2 - 52
order by s_store_name1, s_store_id1, d_week_seq1
limit 100
""",
    77: """
with ss as (
    select s_store_sk, sum(ss_ext_sales_price) as sales,
        sum(ss_net_profit) as profit
    from store_sales, date_dim, store
    where ss_sold_date_sk = d_date_sk
        and d_date between cast('2000-08-03' as date)
            and (cast('2000-08-03' as date) + interval '30' day)
        and ss_store_sk = s_store_sk
    group by s_store_sk),
sr as (
    select s_store_sk, sum(sr_return_amt) as returns_amt,
        sum(sr_net_loss) as profit_loss
    from store_returns, date_dim, store
    where sr_returned_date_sk = d_date_sk
        and d_date between cast('2000-08-03' as date)
            and (cast('2000-08-03' as date) + interval '30' day)
        and sr_store_sk = s_store_sk
    group by s_store_sk),
cs as (
    select cs_call_center_sk, sum(cs_ext_sales_price) as sales,
        sum(cs_net_profit) as profit
    from catalog_sales, date_dim
    where cs_sold_date_sk = d_date_sk
        and d_date between cast('2000-08-03' as date)
            and (cast('2000-08-03' as date) + interval '30' day)
    group by cs_call_center_sk),
cr as (
    select cr_call_center_sk, sum(cr_return_amount) as returns_amt,
        sum(cr_net_loss) as profit_loss
    from catalog_returns, date_dim
    where cr_returned_date_sk = d_date_sk
        and d_date between cast('2000-08-03' as date)
            and (cast('2000-08-03' as date) + interval '30' day)
    group by cr_call_center_sk),
ws as (
    select wp_web_page_sk, sum(ws_ext_sales_price) as sales,
        sum(ws_net_profit) as profit
    from web_sales, date_dim, web_page
    where ws_sold_date_sk = d_date_sk
        and d_date between cast('2000-08-03' as date)
            and (cast('2000-08-03' as date) + interval '30' day)
        and ws_web_page_sk = wp_web_page_sk
    group by wp_web_page_sk),
wr as (
    select wp_web_page_sk, sum(wr_return_amt) as returns_amt,
        sum(wr_net_loss) as profit_loss
    from web_returns, date_dim, web_page
    where wr_returned_date_sk = d_date_sk
        and d_date between cast('2000-08-03' as date)
            and (cast('2000-08-03' as date) + interval '30' day)
        and wr_web_page_sk = wp_web_page_sk
    group by wp_web_page_sk)
select channel, id, sum(sales) as sales,
    sum(returns_amt) as returns_amt, sum(profit) as profit
from (select 'store channel' as channel, ss.s_store_sk as id,
          ss.sales sales, coalesce(sr.returns_amt, 0) returns_amt,
          (ss.profit - coalesce(sr.profit_loss, 0)) as profit
      from ss left join sr on ss.s_store_sk = sr.s_store_sk
      union all
      select 'catalog channel' as channel,
          cs.cs_call_center_sk as id, cs.sales sales,
          coalesce(cr.returns_amt, 0) returns_amt,
          (cs.profit - coalesce(cr.profit_loss, 0)) as profit
      from cs left join cr
          on cs.cs_call_center_sk = cr.cr_call_center_sk
      union all
      select 'web channel' as channel, ws.wp_web_page_sk as id,
          ws.sales sales, coalesce(wr.returns_amt, 0) returns_amt,
          (ws.profit - coalesce(wr.profit_loss, 0)) as profit
      from ws left join wr
          on ws.wp_web_page_sk = wr.wp_web_page_sk) x
group by rollup(channel, id)
order by channel nulls first, id nulls first, sales
limit 100
""",
    8: """
select s_store_name, sum(ss_net_profit)
from store_sales, date_dim, store,
    (select ca_zip from (
        select substr(ca_zip, 1, 5) ca_zip
        from customer_address
        where substr(ca_zip, 1, 5) in ('47602', '16704', '35863',
                                       '28577', '83910', '36201')
        intersect
        select ca_zip from (
            select substr(ca_zip, 1, 5) ca_zip, count(*) cnt
            from customer_address, customer
            where ca_address_sk = c_current_addr_sk
                and c_preferred_cust_flag = 'Y'
            group by ca_zip
            having count(*) > 10) a1) a2) v1
where ss_store_sk = s_store_sk
    and ss_sold_date_sk = d_date_sk
    and d_qoy = 2 and d_year = 1998
    and substr(s_zip, 1, 2) = substr(v1.ca_zip, 1, 2)
group by s_store_name
order by s_store_name
limit 100
""",
    66: """
select w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
    w_country, ship_carriers, year1,
    sum(jan_sales) as jan_sales, sum(feb_sales) as feb_sales,
    sum(mar_sales) as mar_sales, sum(apr_sales) as apr_sales,
    sum(may_sales) as may_sales, sum(jun_sales) as jun_sales,
    sum(jul_sales) as jul_sales, sum(aug_sales) as aug_sales,
    sum(sep_sales) as sep_sales, sum(oct_sales) as oct_sales,
    sum(nov_sales) as nov_sales, sum(dec_sales) as dec_sales
from (
    select w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
        w_state, w_country,
        'CARRIER0' || ',' || 'CARRIER1' as ship_carriers,
        d_year as year1,
        sum(case when d_moy = 1 then ws_ext_sales_price * ws_quantity
            else 0 end) as jan_sales,
        sum(case when d_moy = 2 then ws_ext_sales_price * ws_quantity
            else 0 end) as feb_sales,
        sum(case when d_moy = 3 then ws_ext_sales_price * ws_quantity
            else 0 end) as mar_sales,
        sum(case when d_moy = 4 then ws_ext_sales_price * ws_quantity
            else 0 end) as apr_sales,
        sum(case when d_moy = 5 then ws_ext_sales_price * ws_quantity
            else 0 end) as may_sales,
        sum(case when d_moy = 6 then ws_ext_sales_price * ws_quantity
            else 0 end) as jun_sales,
        sum(case when d_moy = 7 then ws_ext_sales_price * ws_quantity
            else 0 end) as jul_sales,
        sum(case when d_moy = 8 then ws_ext_sales_price * ws_quantity
            else 0 end) as aug_sales,
        sum(case when d_moy = 9 then ws_ext_sales_price * ws_quantity
            else 0 end) as sep_sales,
        sum(case when d_moy = 10 then ws_ext_sales_price * ws_quantity
            else 0 end) as oct_sales,
        sum(case when d_moy = 11 then ws_ext_sales_price * ws_quantity
            else 0 end) as nov_sales,
        sum(case when d_moy = 12 then ws_ext_sales_price * ws_quantity
            else 0 end) as dec_sales
    from web_sales, warehouse, date_dim, time_dim, ship_mode
    where ws_warehouse_sk = w_warehouse_sk
        and ws_sold_date_sk = d_date_sk
        and ws_sold_time_sk = t_time_sk
        and ws_ship_mode_sk = sm_ship_mode_sk
        and d_year = 2001
        and t_time between 30838 and 30838 + 28800
        and sm_carrier in ('CARRIER0', 'CARRIER1')
    group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
        w_state, w_country, d_year
    union all
    select w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
        w_state, w_country,
        'CARRIER0' || ',' || 'CARRIER1' as ship_carriers,
        d_year as year1,
        sum(case when d_moy = 1 then cs_ext_sales_price * cs_quantity
            else 0 end) as jan_sales,
        sum(case when d_moy = 2 then cs_ext_sales_price * cs_quantity
            else 0 end) as feb_sales,
        sum(case when d_moy = 3 then cs_ext_sales_price * cs_quantity
            else 0 end) as mar_sales,
        sum(case when d_moy = 4 then cs_ext_sales_price * cs_quantity
            else 0 end) as apr_sales,
        sum(case when d_moy = 5 then cs_ext_sales_price * cs_quantity
            else 0 end) as may_sales,
        sum(case when d_moy = 6 then cs_ext_sales_price * cs_quantity
            else 0 end) as jun_sales,
        sum(case when d_moy = 7 then cs_ext_sales_price * cs_quantity
            else 0 end) as jul_sales,
        sum(case when d_moy = 8 then cs_ext_sales_price * cs_quantity
            else 0 end) as aug_sales,
        sum(case when d_moy = 9 then cs_ext_sales_price * cs_quantity
            else 0 end) as sep_sales,
        sum(case when d_moy = 10 then cs_ext_sales_price * cs_quantity
            else 0 end) as oct_sales,
        sum(case when d_moy = 11 then cs_ext_sales_price * cs_quantity
            else 0 end) as nov_sales,
        sum(case when d_moy = 12 then cs_ext_sales_price * cs_quantity
            else 0 end) as dec_sales
    from catalog_sales, warehouse, date_dim, time_dim, ship_mode
    where cs_warehouse_sk = w_warehouse_sk
        and cs_sold_date_sk = d_date_sk
        and cs_sold_time_sk = t_time_sk
        and cs_ship_mode_sk = sm_ship_mode_sk
        and d_year = 2001
        and t_time between 30838 and 30838 + 28800
        and sm_carrier in ('CARRIER0', 'CARRIER1')
    group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
        w_state, w_country, d_year) x
group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
    w_state, w_country, ship_carriers, year1
order by w_warehouse_name
limit 100
""",
    78: """
with ws as (
    select d_year as ws_sold_year, ws_item_sk,
        ws_customer_sk ws_customer_sk,
        sum(ws_quantity) ws_qty,
        sum(ws_wholesale_cost) ws_wc,
        sum(ws_sales_price) ws_sp
    from web_sales
    left join web_returns on wr_order_number = ws_order_number
        and ws_item_sk = wr_item_sk
    join date_dim on ws_sold_date_sk = d_date_sk
    where wr_order_number is null
    group by d_year, ws_item_sk, ws_customer_sk),
ss as (
    select d_year as ss_sold_year, ss_item_sk,
        ss_customer_sk ss_customer_sk,
        sum(ss_quantity) ss_qty,
        sum(ss_wholesale_cost) ss_wc,
        sum(ss_sales_price) ss_sp
    from store_sales
    left join store_returns on sr_ticket_number = ss_ticket_number
        and ss_item_sk = sr_item_sk
    join date_dim on ss_sold_date_sk = d_date_sk
    where sr_ticket_number is null
    group by d_year, ss_item_sk, ss_customer_sk)
select ss_sold_year, ss_item_sk, ss_customer_sk,
    round(ss_qty / (coalesce(ws_qty, 1)), 2) ratio,
    ss_qty store_qty, ss_wc store_wholesale_cost,
    ss_sp store_sales_price,
    coalesce(ws_qty, 0) other_chan_qty,
    coalesce(ws_wc, 0) other_chan_wholesale_cost,
    coalesce(ws_sp, 0) other_chan_sales_price
from ss
left join ws on ws_sold_year = ss_sold_year
    and ws_item_sk = ss_item_sk
    and ws_customer_sk = ss_customer_sk
where coalesce(ws_qty, 0) > 0 and ss_sold_year = 2000
order by ss_sold_year, ss_item_sk, ss_customer_sk, store_qty desc,
    store_wholesale_cost desc, store_sales_price desc,
    other_chan_qty, other_chan_wholesale_cost,
    other_chan_sales_price, ratio
limit 100
""",
    5: """
with ssr as
 (select s_store_id,
         sum(sales_price) as sales, sum(profit) as profit,
         sum(return_amt) as returns_amt, sum(net_loss) as profit_loss
  from (select ss_store_sk as store_sk, ss_sold_date_sk as date_sk,
               ss_ext_sales_price as sales_price, ss_net_profit as profit,
               0.0 as return_amt, 0.0 as net_loss
        from store_sales
        union all
        select sr_store_sk as store_sk, sr_returned_date_sk as date_sk,
               0.0 as sales_price, 0.0 as profit,
               sr_return_amt as return_amt, sr_net_loss as net_loss
        from store_returns) salesreturns, date_dim, store
  where date_sk = d_date_sk
      and d_date between date '2000-08-23' and date '2000-09-06'
      and store_sk = s_store_sk
  group by s_store_id),
 csr as
 (select cp_catalog_page_id,
         sum(sales_price) as sales, sum(profit) as profit,
         sum(return_amt) as returns_amt, sum(net_loss) as profit_loss
  from (select cs_catalog_page_sk as page_sk, cs_sold_date_sk as date_sk,
               cs_ext_sales_price as sales_price, cs_net_profit as profit,
               0.0 as return_amt, 0.0 as net_loss
        from catalog_sales
        union all
        select cr_catalog_page_sk as page_sk, cr_returned_date_sk as date_sk,
               0.0 as sales_price, 0.0 as profit,
               cr_return_amount as return_amt, cr_net_loss as net_loss
        from catalog_returns) salesreturns, date_dim, catalog_page
  where date_sk = d_date_sk
      and d_date between date '2000-08-23' and date '2000-09-06'
      and page_sk = cp_catalog_page_sk
  group by cp_catalog_page_id),
 wsr as
 (select web_site_id,
         sum(sales_price) as sales, sum(profit) as profit,
         sum(return_amt) as returns_amt, sum(net_loss) as profit_loss
  from (select ws_web_site_sk as wsr_web_site_sk,
               ws_sold_date_sk as date_sk,
               ws_ext_sales_price as sales_price, ws_net_profit as profit,
               0.0 as return_amt, 0.0 as net_loss
        from web_sales
        union all
        select ws_web_site_sk as wsr_web_site_sk,
               wr_returned_date_sk as date_sk,
               0.0 as sales_price, 0.0 as profit,
               wr_return_amt as return_amt, wr_net_loss as net_loss
        from web_returns left outer join web_sales on
            (wr_item_sk = ws_item_sk
             and wr_order_number = ws_order_number)) salesreturns,
       date_dim, web_site
  where date_sk = d_date_sk
      and d_date between date '2000-08-23' and date '2000-09-06'
      and wsr_web_site_sk = web_site_sk
  group by web_site_id)
select channel, id, sum(sales) as sales, sum(returns_amt) as returns_amt,
    sum(profit) as profit
from (select 'store channel' as channel, 'store' || s_store_id as id,
             sales, returns_amt, profit - profit_loss as profit
      from ssr
      union all
      select 'catalog channel' as channel,
             'catalog_page' || cp_catalog_page_id as id,
             sales, returns_amt, profit - profit_loss as profit
      from csr
      union all
      select 'web channel' as channel, 'web_site' || web_site_id as id,
             sales, returns_amt, profit - profit_loss as profit
      from wsr) x
group by rollup (channel, id)
order by channel, id
limit 100
""",
    14: """
with cross_items as
 (select i_item_sk ss_item_sk
  from item,
       (select iss.i_brand_id brand_id, iss.i_class_id class_id,
               iss.i_category_id category_id
        from store_sales, item iss, date_dim d1
        where ss_item_sk = iss.i_item_sk
            and ss_sold_date_sk = d1.d_date_sk
            and d1.d_year between 1999 and 1999 + 2
        intersect
        select ics.i_brand_id, ics.i_class_id, ics.i_category_id
        from catalog_sales, item ics, date_dim d2
        where cs_item_sk = ics.i_item_sk
            and cs_sold_date_sk = d2.d_date_sk
            and d2.d_year between 1999 and 1999 + 2
        intersect
        select iws.i_brand_id, iws.i_class_id, iws.i_category_id
        from web_sales, item iws, date_dim d3
        where ws_item_sk = iws.i_item_sk
            and ws_sold_date_sk = d3.d_date_sk
            and d3.d_year between 1999 and 1999 + 2) x
  where i_brand_id = brand_id and i_class_id = class_id
      and i_category_id = category_id),
 avg_sales as
 (select avg(quantity * list_price) average_sales
  from (select ss_quantity quantity, ss_list_price list_price
        from store_sales, date_dim
        where ss_sold_date_sk = d_date_sk
            and d_year between 1999 and 1999 + 2
        union all
        select cs_quantity quantity, cs_list_price list_price
        from catalog_sales, date_dim
        where cs_sold_date_sk = d_date_sk
            and d_year between 1999 and 1999 + 2
        union all
        select ws_quantity quantity, ws_list_price list_price
        from web_sales, date_dim
        where ws_sold_date_sk = d_date_sk
            and d_year between 1999 and 1999 + 2) x)
select channel, i_brand_id, i_class_id, i_category_id, sum(sales) sales,
    sum(number_sales) number_sales
from (select 'store' channel, i_brand_id, i_class_id, i_category_id,
             sum(ss_quantity * ss_list_price) sales,
             count(*) number_sales
      from store_sales, item, date_dim
      where ss_item_sk in (select ss_item_sk from cross_items)
          and ss_item_sk = i_item_sk
          and ss_sold_date_sk = d_date_sk
          and d_year = 2001 and d_moy = 11
      group by i_brand_id, i_class_id, i_category_id
      having sum(ss_quantity * ss_list_price) >
          (select average_sales from avg_sales)
      union all
      select 'catalog' channel, i_brand_id, i_class_id, i_category_id,
             sum(cs_quantity * cs_list_price) sales,
             count(*) number_sales
      from catalog_sales, item, date_dim
      where cs_item_sk in (select ss_item_sk from cross_items)
          and cs_item_sk = i_item_sk
          and cs_sold_date_sk = d_date_sk
          and d_year = 2001 and d_moy = 11
      group by i_brand_id, i_class_id, i_category_id
      having sum(cs_quantity * cs_list_price) >
          (select average_sales from avg_sales)
      union all
      select 'web' channel, i_brand_id, i_class_id, i_category_id,
             sum(ws_quantity * ws_list_price) sales,
             count(*) number_sales
      from web_sales, item, date_dim
      where ws_item_sk in (select ss_item_sk from cross_items)
          and ws_item_sk = i_item_sk
          and ws_sold_date_sk = d_date_sk
          and d_year = 2001 and d_moy = 11
      group by i_brand_id, i_class_id, i_category_id
      having sum(ws_quantity * ws_list_price) >
          (select average_sales from avg_sales)) y
group by rollup (channel, i_brand_id, i_class_id, i_category_id)
order by channel nulls last, i_brand_id nulls last, i_class_id nulls last,
    i_category_id nulls last
limit 100
""",
    24: """
with ssales as
 (select c_last_name, c_first_name, s_store_name, ca_state, s_state,
         i_color, i_current_price, i_manager_id, i_units, i_size,
         sum(ss_net_paid) netpaid
  from store_sales, store_returns, store, item, customer,
       customer_address
  where ss_ticket_number = sr_ticket_number
      and ss_item_sk = sr_item_sk
      and ss_customer_sk = c_customer_sk
      and ss_item_sk = i_item_sk
      and ss_store_sk = s_store_sk
      and c_current_addr_sk = ca_address_sk
      and c_birth_country <> upper(ca_country)
      and s_market_id <= 5
  group by c_last_name, c_first_name, s_store_name, ca_state, s_state,
      i_color, i_current_price, i_manager_id, i_units, i_size)
select c_last_name, c_first_name, s_store_name, sum(netpaid) paid
from ssales
where i_color = 'red'
group by c_last_name, c_first_name, s_store_name
having sum(netpaid) > (select 0.05 * avg(netpaid) from ssales)
order by c_last_name, c_first_name, s_store_name
""",
    44: """
select asceding.rnk, i1.i_product_name best_performing,
    i2.i_product_name worst_performing
from (select *
      from (select item_sk, rank() over (order by rank_col asc) rnk
            from (select ss_item_sk item_sk, avg(ss_net_profit) rank_col
                  from store_sales ss1 where ss_store_sk = 4
                  group by ss_item_sk
                  having avg(ss_net_profit) > 0.9 *
                      (select avg(ss_net_profit) rank_col
                       from store_sales
                       where ss_store_sk = 4 and ss_sold_time_sk is null
                       group by ss_store_sk)) v1) v11
      where rnk < 11) asceding,
     (select *
      from (select item_sk, rank() over (order by rank_col desc) rnk
            from (select ss_item_sk item_sk, avg(ss_net_profit) rank_col
                  from store_sales ss1 where ss_store_sk = 4
                  group by ss_item_sk
                  having avg(ss_net_profit) > 0.9 *
                      (select avg(ss_net_profit) rank_col
                       from store_sales
                       where ss_store_sk = 4 and ss_sold_time_sk is null
                       group by ss_store_sk)) v2) v21
      where rnk < 11) descending,
     item i1, item i2
where asceding.rnk = descending.rnk
    and i1.i_item_sk = asceding.item_sk
    and i2.i_item_sk = descending.item_sk
order by asceding.rnk
limit 100
""",
    49: """
select channel, item, return_ratio, return_rank, currency_rank
from (select 'web' as channel, web.item, web.return_ratio,
             web.return_rank, web.currency_rank
      from 
 (select item, return_ratio, currency_ratio,
         rank() over (order by return_ratio) as return_rank,
         rank() over (order by currency_ratio) as currency_rank
  from (select ws_item_sk as item,
               cast(sum(coalesce(wr_return_quantity, 0)) as double) /
                   cast(sum(coalesce(ws_quantity, 0)) as double)
                   as return_ratio,
               cast(sum(coalesce(wr_return_amt, 0.0)) as double) /
                   cast(sum(coalesce(ws_net_paid, 0.0)) as double)
                   as currency_ratio
        from web_sales left outer join web_returns on
             (ws_order_number = wr_order_number and ws_item_sk = wr_item_sk),
             date_dim
        where wr_return_amt > 100
            and ws_net_profit > 1
            and ws_net_paid > 0 and ws_quantity > 0
            and ws_sold_date_sk = d_date_sk
            and d_year = 2001 and d_moy = 12
        group by ws_item_sk) in_ws) web
      where web.return_rank <= 10 or web.currency_rank <= 10
      union
      select 'catalog' as channel, catalog.item, catalog.return_ratio,
             catalog.return_rank, catalog.currency_rank
      from 
 (select item, return_ratio, currency_ratio,
         rank() over (order by return_ratio) as return_rank,
         rank() over (order by currency_ratio) as currency_rank
  from (select cs_item_sk as item,
               cast(sum(coalesce(cr_return_quantity, 0)) as double) /
                   cast(sum(coalesce(cs_quantity, 0)) as double)
                   as return_ratio,
               cast(sum(coalesce(cr_return_amount, 0.0)) as double) /
                   cast(sum(coalesce(cs_net_paid, 0.0)) as double)
                   as currency_ratio
        from catalog_sales left outer join catalog_returns on
             (cs_order_number = cr_order_number and cs_item_sk = cr_item_sk),
             date_dim
        where cr_return_amount > 100
            and cs_net_profit > 1
            and cs_net_paid > 0 and cs_quantity > 0
            and cs_sold_date_sk = d_date_sk
            and d_year = 2001 and d_moy = 12
        group by cs_item_sk) in_cs) catalog
      where catalog.return_rank <= 10 or catalog.currency_rank <= 10
      union
      select 'store' as channel, store.item, store.return_ratio,
             store.return_rank, store.currency_rank
      from 
 (select item, return_ratio, currency_ratio,
         rank() over (order by return_ratio) as return_rank,
         rank() over (order by currency_ratio) as currency_rank
  from (select ss_item_sk as item,
               cast(sum(coalesce(sr_return_quantity, 0)) as double) /
                   cast(sum(coalesce(ss_quantity, 0)) as double)
                   as return_ratio,
               cast(sum(coalesce(sr_return_amt, 0.0)) as double) /
                   cast(sum(coalesce(ss_net_paid, 0.0)) as double)
                   as currency_ratio
        from store_sales left outer join store_returns on
             (ss_ticket_number = sr_ticket_number and ss_item_sk = sr_item_sk),
             date_dim
        where sr_return_amt > 100
            and ss_net_profit > 1
            and ss_net_paid > 0 and ss_quantity > 0
            and ss_sold_date_sk = d_date_sk
            and d_year = 2001 and d_moy = 12
        group by ss_item_sk) in_ss) store
      where store.return_rank <= 10 or store.currency_rank <= 10) x
order by 1, 4, 5, 2
limit 100
""",
    67: """
select *
from (select i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
             d_moy, s_store_id, sumsales,
             rank() over (partition by i_category
                          order by sumsales desc) rk
      from (select i_category, i_class, i_brand, i_product_name, d_year,
                   d_qoy, d_moy, s_store_id,
                   sum(coalesce(ss_sales_price * ss_quantity, 0.0))
                       sumsales
            from store_sales, date_dim, store, item
            where ss_sold_date_sk = d_date_sk
                and ss_item_sk = i_item_sk
                and ss_store_sk = s_store_sk
                and d_month_seq between 24 and 35
            group by rollup(i_category, i_class, i_brand, i_product_name,
                d_year, d_qoy, d_moy, s_store_id)) dw1) dw2
where rk <= 100
order by i_category nulls last, i_class nulls last, i_brand nulls last,
    i_product_name nulls last, d_year nulls last, d_qoy nulls last,
    d_moy nulls last, s_store_id nulls last, sumsales, rk
limit 100
""",
    71: """
select i_brand_id brand_id, i_brand brand, t_hour, t_minute,
    sum(ext_price) ext_price
from item,
     (select ws_ext_sales_price as ext_price,
             ws_sold_date_sk as sold_date_sk,
             ws_item_sk as sold_item_sk, ws_sold_time_sk as time_sk
      from web_sales, date_dim
      where d_date_sk = ws_sold_date_sk and d_moy = 11 and d_year = 1999
      union all
      select cs_ext_sales_price as ext_price,
             cs_sold_date_sk as sold_date_sk,
             cs_item_sk as sold_item_sk, cs_sold_time_sk as time_sk
      from catalog_sales, date_dim
      where d_date_sk = cs_sold_date_sk and d_moy = 11 and d_year = 1999
      union all
      select ss_ext_sales_price as ext_price,
             ss_sold_date_sk as sold_date_sk,
             ss_item_sk as sold_item_sk, ss_sold_time_sk as time_sk
      from store_sales, date_dim
      where d_date_sk = ss_sold_date_sk and d_moy = 11 and d_year = 1999
     ) tmp, time_dim
where sold_item_sk = i_item_sk
    and i_manager_id = 1
    and time_sk = t_time_sk
    and (t_meal_time = 'breakfast' or t_meal_time = 'dinner')
group by i_brand, i_brand_id, t_hour, t_minute
order by ext_price desc, i_brand_id, t_hour, t_minute
""",
    75: """
with all_sales as
 (select d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id,
         sum(sales_cnt) as sales_cnt, sum(sales_amt) as sales_amt
  from (select d_year, i_brand_id, i_class_id, i_category_id,
               i_manufact_id,
               cs_quantity - coalesce(cr_return_quantity, 0) as sales_cnt,
               cs_ext_sales_price - coalesce(cr_return_amount, 0.0)
                   as sales_amt
        from catalog_sales
             join item on i_item_sk = cs_item_sk
             join date_dim on d_date_sk = cs_sold_date_sk
             left join catalog_returns on
                 (cs_order_number = cr_order_number
                  and cs_item_sk = cr_item_sk)
        where i_category = 'Books'
        union
        select d_year, i_brand_id, i_class_id, i_category_id,
               i_manufact_id,
               ss_quantity - coalesce(sr_return_quantity, 0) as sales_cnt,
               ss_ext_sales_price - coalesce(sr_return_amt, 0.0)
                   as sales_amt
        from store_sales
             join item on i_item_sk = ss_item_sk
             join date_dim on d_date_sk = ss_sold_date_sk
             left join store_returns on
                 (ss_ticket_number = sr_ticket_number
                  and ss_item_sk = sr_item_sk)
        where i_category = 'Books'
        union
        select d_year, i_brand_id, i_class_id, i_category_id,
               i_manufact_id,
               ws_quantity - coalesce(wr_return_quantity, 0) as sales_cnt,
               ws_ext_sales_price - coalesce(wr_return_amt, 0.0)
                   as sales_amt
        from web_sales
             join item on i_item_sk = ws_item_sk
             join date_dim on d_date_sk = ws_sold_date_sk
             left join web_returns on
                 (ws_order_number = wr_order_number
                  and ws_item_sk = wr_item_sk)
        where i_category = 'Books') sales_detail
  group by d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id)
select prev_yr.d_year as prev_year, curr_yr.d_year as curr_year,
    curr_yr.i_brand_id, curr_yr.i_class_id, curr_yr.i_category_id,
    curr_yr.i_manufact_id,
    prev_yr.sales_cnt as prev_yr_cnt, curr_yr.sales_cnt as curr_yr_cnt,
    curr_yr.sales_cnt - prev_yr.sales_cnt as sales_cnt_diff,
    curr_yr.sales_amt - prev_yr.sales_amt as sales_amt_diff
from all_sales curr_yr, all_sales prev_yr
where curr_yr.i_brand_id = prev_yr.i_brand_id
    and curr_yr.i_class_id = prev_yr.i_class_id
    and curr_yr.i_category_id = prev_yr.i_category_id
    and curr_yr.i_manufact_id = prev_yr.i_manufact_id
    and curr_yr.d_year = 2002
    and prev_yr.d_year = 2002 - 1
    and cast(curr_yr.sales_cnt as double) / cast(prev_yr.sales_cnt as double)
        < 0.9
order by sales_cnt_diff, sales_amt_diff
limit 100
""",
    80: """
with ssr as
 (select s_store_id as store_id,
         sum(ss_ext_sales_price) as sales,
         sum(coalesce(sr_return_amt, 0.0)) as returns_amt,
         sum(ss_net_profit - coalesce(sr_net_loss, 0.0)) as profit
  from store_sales left outer join store_returns on
       (ss_item_sk = sr_item_sk and ss_ticket_number = sr_ticket_number),
       date_dim, store, item, promotion
  where ss_sold_date_sk = d_date_sk
      and d_date between date '2000-08-23' and date '2000-09-22'
      and ss_store_sk = s_store_sk
      and ss_item_sk = i_item_sk
      and i_current_price > 50
      and ss_promo_sk = p_promo_sk
      and p_channel_tv = 'N'
  group by s_store_id),
 csr as
 (select cp_catalog_page_id as catalog_page_id,
         sum(cs_ext_sales_price) as sales,
         sum(coalesce(cr_return_amount, 0.0)) as returns_amt,
         sum(cs_net_profit - coalesce(cr_net_loss, 0.0)) as profit
  from catalog_sales left outer join catalog_returns on
       (cs_item_sk = cr_item_sk and cs_order_number = cr_order_number),
       date_dim, catalog_page, item, promotion
  where cs_sold_date_sk = d_date_sk
      and d_date between date '2000-08-23' and date '2000-09-22'
      and cs_catalog_page_sk = cp_catalog_page_sk
      and cs_item_sk = i_item_sk
      and i_current_price > 50
      and cs_promo_sk = p_promo_sk
      and p_channel_tv = 'N'
  group by cp_catalog_page_id),
 wsr as
 (select web_site_id,
         sum(ws_ext_sales_price) as sales,
         sum(coalesce(wr_return_amt, 0.0)) as returns_amt,
         sum(ws_net_profit - coalesce(wr_net_loss, 0.0)) as profit
  from web_sales left outer join web_returns on
       (ws_item_sk = wr_item_sk and ws_order_number = wr_order_number),
       date_dim, web_site, item, promotion
  where ws_sold_date_sk = d_date_sk
      and d_date between date '2000-08-23' and date '2000-09-22'
      and ws_web_site_sk = web_site_sk
      and ws_item_sk = i_item_sk
      and i_current_price > 50
      and ws_promo_sk = p_promo_sk
      and p_channel_tv = 'N'
  group by web_site_id)
select channel, id, sum(sales) as sales, sum(returns_amt) as returns_amt,
    sum(profit) as profit
from (select 'store channel' as channel, 'store' || store_id as id,
             sales, returns_amt, profit
      from ssr
      union all
      select 'catalog channel' as channel,
             'catalog_page' || catalog_page_id as id,
             sales, returns_amt, profit
      from csr
      union all
      select 'web channel' as channel, 'web_site' || web_site_id as id,
             sales, returns_amt, profit
      from wsr) x
group by rollup (channel, id)
order by channel, id
limit 100
""",
    95: """
with ws_wh as
 (select ws1.ws_order_number wh_order, ws1.ws_warehouse_sk wh1,
         ws2.ws_warehouse_sk wh2
  from web_sales ws1, web_sales ws2
  where ws1.ws_order_number = ws2.ws_order_number
    and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
select count(distinct ws_order_number) as order_count,
    sum(ws_ext_list_price) as total_shipping_cost,
    sum(ws_net_profit) as total_net_profit
from web_sales ws1, date_dim, customer_address, web_site
where d_date between date '1999-02-01' and date '1999-04-02'
    and ws1.ws_ship_date_sk = d_date_sk
    and ws1.ws_ship_addr_sk = ca_address_sk
    and ca_state = 'IL'
    and ws1.ws_web_site_sk = web_site_sk
    and web_company_name = 'pri'
    and ws1.ws_order_number in (select wh_order from ws_wh)
    and ws1.ws_order_number in (select wr_order_number
                                from web_returns, ws_wh
                                where wr_order_number = wh_order)
order by count(distinct ws_order_number)
limit 100
""",
}
